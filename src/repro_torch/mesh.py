"""The rank axis on one device: the only collectives the serving path needs.

The reference runs every rank as its own `shard_map` shard on its own
device.  Here all p ranks live on one device as the leading dimension of a
stacked tensor — ``x[r]`` is rank r's block, so a ``[p, ...]`` tensor is
exactly the global view a `shard_map` array has.  Per-rank code becomes code
batched over that leading dimension, and the collectives become indexing:

  * ``axis_index()``            -> ``arange(p)`` (each rank's own id);
  * ``all_gather(x[p, ...])``   -> ``[p, p, ...]``: every rank sees every
    rank's block (a broadcast view, no copy);
  * ``all_to_all(x[p_src, p_dst, ...])`` -> ``[p_dst, p_src, ...]``: block
    (s, d) lands at rank d in slot s (a transpose view);
  * ``ppermute(x[p, ...], perm)`` -> ``out[dst] = x[src]`` per pair, zeros
    where no pair lands, and its uniform-shift fast path ``shift`` (both
    return a new tensor: a put never aliases its source).

A result of `all_gather` is identical at every receiver, so code computing a
rank-independent function of it may read it once (`replicated`).

A multi-process backend (one rank per card, NCCL collectives) can replace
this module later without touching its callers.
"""

from __future__ import annotations

import torch


class MeshError(RuntimeError):
    pass


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA without one raises: the port
    never falls back to the CPU on its own — pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MeshError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class Mesh:
    """p window ranks stacked on one device, named by one axis."""

    def __init__(self, p: int, axis: str = "serve", device=None):
        if p < 1:
            raise MeshError(f"need p >= 1 ranks, got {p}")
        self.p = int(p)
        self.axis = axis
        self.device = resolve_device(device)

    def axis_index(self) -> torch.Tensor:
        """[p] int64: rank r's own index, r."""
        return torch.arange(self.p, device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [p, ...] -> [p(receiver), p(source), ...] (a view)."""
        self._check(x)
        return x.unsqueeze(0).expand((self.p,) + tuple(x.shape))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [p_src, p_dst, ...] -> [p_dst, p_src, ...] (a view)."""
        self._check(x)
        if x.ndim < 2 or x.shape[1] != self.p:
            raise MeshError(f"all_to_all needs [p, p, ...], got {tuple(x.shape)}")
        return x.transpose(0, 1)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """x [p, ...] -> [p, ...] with ``out[dst] = x[src]`` for each
        ``(src, dst)`` pair; ranks that no pair names as a destination get
        zeros (their window is simply not written)."""
        self._check(x)
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        if len(perm):
            src, dst = (torch.tensor(list(c), dtype=torch.int64, device=x.device)
                        for c in zip(*perm))
            out[dst] = x[src]
        return out

    def shift(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """The uniform-shift ppermute: ``out[(r + shift) % p] = x[r]``, as
        one concatenation of two row ranges (one copy kernel, no index
        tensor).  Always a new contiguous tensor."""
        self._check(x)
        s = int(shift) % self.p
        if s == 0:
            return x.clone(memory_format=torch.contiguous_format)
        return torch.cat((x[self.p - s:], x[:self.p - s]))

    @staticmethod
    def replicated(gathered: torch.Tensor) -> torch.Tensor:
        """The one copy of an `all_gather` result every receiver holds."""
        return gathered[0]

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.p:
            raise MeshError(
                f"expected a leading rank dim of {self.p}, got {tuple(x.shape)}")
