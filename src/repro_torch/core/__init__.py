"""repro_torch.core — planner, executors, the engine and their building
blocks (padding, top-k, distances, the plain FD-SQ / FQ-SD scans)."""
