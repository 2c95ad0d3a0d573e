"""repro_torch.parallel — model-guided strategy selection and the bucketed
gradient sync (`overlap`), sharding policies (`sharding`), error-feedback
compression (`compression`) and the GPipe pipeline (`pipeline`)."""
