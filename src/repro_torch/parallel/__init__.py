"""repro_torch.parallel — model-guided strategy selection (`overlap`)."""
