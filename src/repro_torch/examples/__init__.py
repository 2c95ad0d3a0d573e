"""Example programs of the port, the counterparts of `examples/quickstart.py` and
`examples/train_e2e.py`; run each with ``python -m repro_torch.examples.<name>``."""
