"""Training runtime: fault tolerance (straggler detection, crash recovery)."""
