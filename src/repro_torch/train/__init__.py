"""Training: AdamW (`optimizer`), the train / prefill / serve steps
(`train_step`) and the host loop with checkpoints (`trainer`)."""
