"""Causal request stitching: deterministic per-hop edge ids and the request
and epoch scopes (copy of `repro.obs.causal`'s `edge`, `request_scope`,
`current_rid`, `epoch_scope` and `current_epoch_rids`).

A producer-side event carries ``edge=<id>``, the consumer-side event
``cause=<id>``; both sides mint the same id without coordination, and
replays stay byte-identical because no global counter is involved.
``with request_scope(rid):`` binds the current request for leaf sites that
cannot thread a rid through their signatures; ``with epoch_scope(rids):``
binds the requests riding the current communication epoch, which the sync
plane (`core.epoch.flush`) stamps onto its events.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable, Optional

_CURRENT_RID: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "repro_torch_obs_causal_rid", default=None)
_EPOCH_RIDS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_obs_causal_epoch_rids", default=())


def edge(rid: int, hop: str, i: int = 0) -> str:
    """Per-hop edge id, a pure function of (rid, hop, i); `i` disambiguates
    a hop a request crosses more than once."""
    return f"{int(rid)}:{hop}" if i == 0 else f"{int(rid)}:{hop}#{int(i)}"


@contextlib.contextmanager
def request_scope(rid: int):
    """Bind `rid` as the current request for leaf-site attribution."""
    tok = _CURRENT_RID.set(int(rid))
    try:
        yield
    finally:
        _CURRENT_RID.reset(tok)


def current_rid() -> Optional[int]:
    return _CURRENT_RID.get()


@contextlib.contextmanager
def epoch_scope(rids: Iterable[int]):
    """Bind the requests riding the current communication epoch."""
    tok = _EPOCH_RIDS.set(tuple(sorted(int(r) for r in rids)))
    try:
        yield
    finally:
        _EPOCH_RIDS.reset(tok)


def current_epoch_rids() -> tuple:
    return _EPOCH_RIDS.get()
