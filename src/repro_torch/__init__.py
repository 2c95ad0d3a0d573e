"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors its module
paths and names so each counterpart is easy to find, imports `torch` and
numpy only, and never imports `jax` or any module of `repro`.

The mesh axis of the reference becomes a leading rank dimension of one
device tensor (`repro_torch.mesh`): a ``[p, ...]`` tensor is the SPMD global
view that `shard_map` arrays have in the reference.  Every device entry point
takes ``device=None``, meaning ``"cuda"``; with no card present it raises
instead of carrying on quietly on the CPU.  Tests pass ``device="cpu"``.
"""
