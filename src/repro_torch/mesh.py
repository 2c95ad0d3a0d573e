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
    return a new tensor: a put never aliases its source);
  * ``psum_scatter(x[p, p*m, ...])`` -> ``[p, m, ...]``: rank r gets chunk
    r of the sum over ranks (the tiled reduce-scatter).

A result of `all_gather` is identical at every receiver, so code computing a
rank-independent function of it may read it once (`replicated`).

A mesh may also carry several named axes, ``Mesh({"pod": 2, "data": 2})``:
the ranks are then stacked as leading dims in axis order, ``x[pod, data,
...]``.  A collective over one named axis is the one-axis collective above
on the tensor with that axis moved to the front (`front` / `back`) and the
axis's own one-axis mesh (`along`): the other rank dims ride along as
payload, so a put over ``data`` shifts within every pod at once, as
``ppermute`` over ``data`` does inside ``shard_map``.  `psum` over a named
axis is the reference's native ``lax.psum``: a sum over that dim, the same
at every rank of it.

Each collective records its kind (the reference's HLO name), its operand's
bytes (every rank's block on the card) and its group size into a running
`launch.hlo_cost` counter through `obs.cost`'s hooks.

`repro_torch.procmesh.ProcMesh` has this surface for ranks that are
processes of their own (one rank a process, windows in peer-mapped
memory): there a tensor's leading dims hold this process's one rank block,
``[1, ...]`` on one axis and ``[1, 1, ...]`` on a grid, and code that sizes
them by ``mesh.local_ranks`` runs on either mesh.  `NamedAxes` is the
bookkeeping the two share.
"""

from __future__ import annotations

import math

import torch

from .obs import cost


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


class NamedAxes:
    """The axis bookkeeping `Mesh` and `procmesh.ProcMesh` share: a dict of
    named axes (or one axis) in order, ``p`` their rank count, the rank
    dim that carries each axis (`dim`, `front`, `back`) and the checks of
    a tensor's leading rank dims (`rank_dims`: every rank's on a stacked
    mesh, ``[1, 1, ...]`` over processes)."""

    _lead_note = ""

    def _name_axes(self, p, axis) -> None:
        axes = dict(p) if isinstance(p, dict) else {axis: p}
        if not axes or any(int(n) < 1 for n in axes.values()):
            raise MeshError(f"need every axis >= 1 rank, got {axes}")
        self.shape = {str(a): int(n) for a, n in axes.items()}
        self.axis_names = tuple(self.shape)
        self.p = math.prod(self.shape.values())
        self.axis = self.axis_names[0] if len(self.shape) == 1 else self.axis_names

    @property
    def rank_dims(self) -> tuple:
        """The leading dims of a tensor on this mesh, one an axis."""
        raise NotImplementedError

    def dim(self, axis: str) -> int:
        """The rank dim that carries `axis`."""
        if axis not in self.shape:
            raise MeshError(f"mesh axes {self.axis_names} have no axis {axis!r}")
        return self.axis_names.index(axis)

    def front(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x [ranks..., ...] with `axis`'s dim moved first (a view)."""
        return x.movedim(self.dim(axis), 0)

    def back(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Inverse of `front` (a view)."""
        return x.movedim(0, self.dim(axis))

    def _check_rank_dims(self, x: torch.Tensor) -> None:
        want = self.rank_dims
        if tuple(x.shape[:len(want)]) != want:
            raise MeshError(f"expected leading rank dims {want}, got {tuple(x.shape)}")

    def _check(self, x: torch.Tensor) -> None:
        """A one-axis collective's operand: one leading rank dim."""
        if len(self.shape) > 1:
            raise MeshError(f"a mesh of axes {self.axis_names} moves along one named "
                            "axis at a time: use mesh.along(axis)")
        lead = self.rank_dims[0]
        if x.ndim == 0 or x.shape[0] != lead:
            raise MeshError(f"expected a leading rank dim of {lead}{self._lead_note}, "
                            f"got {tuple(x.shape)}")


class Mesh(NamedAxes):
    """p window ranks stacked on one device, named by one axis; or, given a
    dict of named axes, their grid stacked as leading dims in axis order.

    ``p`` and ``axis`` are a one-axis mesh's size and name.  A grid's ``p``
    is its whole rank count and its ``axis`` the tuple of its names; its
    per-axis collectives go through `along`.  ``ranks`` is the rank count of
    the grid a mesh belongs to (``p`` for a one-axis mesh of its own), so a
    payload's per-rank bytes are ``numel / ranks`` either way."""

    def __init__(self, p, axis: str = "serve", device=None, *, ranks=None):
        self._name_axes(p, axis)
        self.ranks = self.p if ranks is None else int(ranks)
        self.device = resolve_device(device)

    @property
    def local_ranks(self) -> int:
        """The rank blocks a tensor on this mesh holds: every rank's."""
        return self.ranks

    @property
    def rank_dims(self) -> tuple:
        """Every rank's block: one dim an axis, of the axis's size."""
        return tuple(self.shape.values())

    # ------------------------------------------------------- named axes
    def along(self, axis: str) -> "Mesh":
        """The one-axis mesh of `axis`: its collectives act on a tensor whose
        leading dim is `axis` (`front`), the other rank dims riding along."""
        self.dim(axis)
        if len(self.shape) == 1:
            return self
        return Mesh(self.shape[axis], axis, self.device, ranks=self.ranks)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum`` over `axis`: every rank of it holds the sum over it.
        A new tensor with x's strides, so a view `front` made of x stays a
        view of the result."""
        self._check_rank_dims(x)
        d = self.dim(axis)
        cost.record_collective("all-reduce", x.nbytes, self.shape[axis],
                               self.p // self.shape[axis])
        out = torch.empty_like(x)
        return out.copy_(x.sum(d, keepdim=True, dtype=x.dtype).expand_as(x))

    def axis_index(self) -> torch.Tensor:
        """[p] int64: rank r's own index, r."""
        return torch.arange(self.p, device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [p, ...] -> [p(receiver), p(source), ...] (a view)."""
        self._check(x)
        cost.record_collective("all-gather", x.nbytes, self.p)
        return x.unsqueeze(0).expand((self.p,) + tuple(x.shape))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [p_src, p_dst, ...] -> [p_dst, p_src, ...] (a view)."""
        self._check(x)
        if x.ndim < 2 or x.shape[1] != self.p:
            raise MeshError(f"all_to_all needs [p, p, ...], got {tuple(x.shape)}")
        cost.record_collective("all-to-all", x.nbytes, self.p)
        return x.transpose(0, 1)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """x [p, ...] -> [p, ...] with ``out[dst] = x[src]`` for each
        ``(src, dst)`` pair; ranks that no pair names as a destination get
        zeros (their window is simply not written)."""
        self._check(x)
        cost.record_collective("collective-permute", x.nbytes, self.p)
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
        cost.record_collective("collective-permute", x.nbytes, self.p)
        s = int(shift) % self.p
        if s == 0:
            return x.clone(memory_format=torch.contiguous_format)
        return torch.cat((x[self.p - s:], x[:self.p - s]))

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled reduce-scatter: x [p, p*m, ...] -> [p, m, ...], rank r
        holding chunk r of ``x.sum(0)``."""
        self._check(x)
        if x.ndim < 2 or x.shape[1] % self.p:
            raise MeshError(f"psum_scatter needs [p, p*m, ...], got {tuple(x.shape)}")
        cost.record_collective("reduce-scatter", x.nbytes, self.p)
        return x.sum(0, dtype=x.dtype).reshape((self.p, x.shape[1] // self.p) + tuple(x.shape[2:]))

    @staticmethod
    def replicated(gathered: torch.Tensor) -> torch.Tensor:
        """The one copy of an `all_gather` result every receiver holds."""
        return gathered[0]

    @staticmethod
    def host_gather(x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of x on the host, [p, ...]: the stacked x
        holds them all (`ProcMesh.host_gather` is the collective read)."""
        return x.cpu()
