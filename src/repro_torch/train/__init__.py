"""repro_torch.train — optimizer, metrics and the training loop."""
