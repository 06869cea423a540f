"""repro_torch.launch — command-line entry points (``python -m repro_torch.launch.serve``)."""
