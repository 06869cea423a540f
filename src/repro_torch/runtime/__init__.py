"""Distributed runtime: sharding rules and placement, fault tolerance, elasticity."""
