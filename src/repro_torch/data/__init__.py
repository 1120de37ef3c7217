"""repro_torch.data — host-side (numpy) synthetic data."""
