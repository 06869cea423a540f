"""repro_torch.data — seeded synthetic datasets and query streams."""
