"""The cost counter's hooks: what the mesh, the kernels' wrappers and the
models call to report to a running `launch.hlo_cost` counter.

Each hook is a no-op while no counter runs, so the hot paths pay one list
read.  A counter is any object with the methods these hooks call
(`launch.hlo_cost.CostCounter`); `running` makes it the active one.  This
module imports nothing of `repro_torch`, so the lowest layers can report
without depending on the launch layer above them.

  * `report_kernel`: a hand kernel's launch, which no dispatch mode sees
    (the kernels launch through ctypes), with its bound's FLOPs and bytes;
  * `record_collective`: one of `Mesh`'s collectives, by kind, operand
    bytes and group size;
  * `scope`: attribute the ops inside (and their backward) to a name;
  * `repeat`: fold a loop of identical trips to one trip counted n times.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_ACTIVE: list = []


def active() -> Optional[Any]:
    """The innermost running counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def running(counter):
    """Make `counter` the active one inside the block."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.pop()


def report_kernel(name: str, flops: float, nbytes: float, product: bool = True) -> None:
    """A hand kernel's launch: its FLOPs (products on the tensor cores when
    `product`) and the bytes it moves, into the active counter if any."""
    c = active()
    if c is not None:
        c.add(flops, nbytes, product, kernel=name)


def record_collective(kind: str, nbytes: int, group_size: int, groups: int = 1) -> None:
    """One collective of `kind` over `group_size` ranks, `nbytes` of operand,
    into the active counter if any."""
    c = active()
    if c is not None:
        c.record_collective(kind, nbytes, group_size, groups)


@contextlib.contextmanager
def scope(name: str):
    """Attribute the ops inside (and their backward) to `name`; a no-op when
    no counter runs."""
    c = active()
    if c is None:
        yield
        return
    c.push_scope(name)
    try:
        yield
    finally:
        c.pop_scope()


class repeat:
    """``with repeat(n) as rep:`` runs its body once and counts it n times:
    a Python loop whose trips all have the same shapes (on meta tensors,
    where every trip's result is the same) folded to one trip, as the
    reference's HLO counts a ``while`` body once times its trip count.  Its
    ops, the same ops in the backward and the storage still alive at its
    end count n times, except the storage `carried` names (the loop's
    state, which the next trip replaces).  A no-op without a running
    counter or for n = 1."""

    def __init__(self, n: int):
        self.n = int(n)
        self.counter = active()
        self.carry: set[int] = set()
        self.token = None

    def carried(self, *tensors) -> None:
        self.carry.update(t.untyped_storage()._cdata for t in tensors)

    def __enter__(self) -> "repeat":
        if self.counter is not None and self.n != 1:
            self.token = self.counter.begin_repeat(self.n)
        return self

    def __exit__(self, *exc) -> None:
        if self.token is not None:
            self.counter.end_repeat(self.token, self.carry, exc)
