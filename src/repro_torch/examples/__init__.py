"""Example programs of the port, the counterparts of `examples/*.py`
(quickstart, train_e2e, disagg_serve, hashtable_kv, milc_stencil, moe_dsde,
fft3d); run each with ``python -m repro_torch.examples.<name>`` (on the
card unless ``--device cpu``)."""
