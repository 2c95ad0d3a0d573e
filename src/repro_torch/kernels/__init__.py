"""repro_torch.kernels — hand-written CUDA kernels for Hopper, each beside
its plain PyTorch version (`ref.py`) and its wrapper (`ops.py`).  Sources
live in ``repro_torch/csrc/``; `common` builds and loads them."""
