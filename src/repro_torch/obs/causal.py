"""Causal request stitching: deterministic per-hop edge ids (copy of
`repro.obs.causal.edge`).

A producer-side event carries ``edge=<id>``, the consumer-side event
``cause=<id>``; both sides mint the same id without coordination, and
replays stay byte-identical because no global counter is involved.
"""

from __future__ import annotations


def edge(rid: int, hop: str, i: int = 0) -> str:
    """Per-hop edge id, a pure function of (rid, hop, i); `i` disambiguates
    a hop a request crosses more than once."""
    return f"{int(rid)}:{hop}" if i == 0 else f"{int(rid)}:{hop}#{int(i)}"
