"""Causal request stitching across ranks (DESIGN.md §15).

PAPERS.md's "Quo Vadis MPI RMA?" argues the dominant cost of one-sided
programs is *synchronization*, and the tracer (`obs.trace`) can already
show per-rank span streams — but a per-rank stream cannot answer the question that
matters for a serving stack: **which** fence, credit stall, or page-pool
dry spell did *this request's* TTFT go to?  This module adds the causal
layer: a request id and per-hop edge ids ride the existing trace events at
every producer/consumer boundary of the serve path (prefill → enqueue
epoch → fabric put/notify → decode dequeue → page scatter → attend →
first token), so a flat trace reassembles into one connected per-request
DAG across ranks — virtual-time exact under `sim.sched`, wall-µs on host.

Three mechanisms, all trace-gated (zero cost when the tracer is off):

  * **Edge ids** — `edge(rid, hop)` mints a deterministic id (a pure
    function of its inputs; no global counter, so replays are
    byte-identical).  A producer-side event carries ``edge=<id>``; the
    consumer-side event carries ``cause=<id>``.  `build_dags` joins them.
  * **Request scope** — ``with request_scope(rid):`` binds the current
    request id in a context variable; instrumented leaf sites that cannot
    thread a rid through their signatures (heap alloc/free, flush events)
    read it via `current_rid()` and stamp their events.
  * **Epoch scope** — ``with epoch_scope(rids):`` binds the set of
    requests riding the current communication epoch; the fabric sync plane
    (`flush`/`flush_remote`/`fence`) stamps those rids onto its events so
    `obs.critpath.SyncLedger` can attribute every synchronization wait to
    the epoch *and* the requests that paid it.

Reserved attribute keys: ``edge`` and ``cause`` are graph links and are
only meaningful on *instant events* (a link fires at a point in time; a
span's [ts, ts+dur] interval has no single firing point, and `Span.set`
updates could silently corrupt a link mid-flight).  `Tracer.span` rejects
them — see RESERVED_SPAN_ATTRS in `obs.trace`.

DAG construction joins on two relations:

  1. explicit edges: producer event ``edge=E`` → every event ``cause=E``;
  2. program order: consecutive events carrying the same ``rid`` on the
     same rank chain in timestamp order (the within-rank activity line).

`RequestDAG.connected()` is the acceptance check: a completed request's
events must form ONE weakly-connected component across all ranks touched.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterable, Optional, Sequence

# attrs `Tracer.span` must reject (stitching links live on instant events)
RESERVED_SPAN_ATTRS = frozenset({"edge", "cause"})

_CURRENT_RID: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "repro_torch_obs_causal_rid", default=None)
_EPOCH_RIDS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_obs_causal_epoch_rids", default=())


def edge(rid: int, hop: str, i: int = 0) -> str:
    """Deterministic per-hop edge id: a pure function of (rid, hop, i).

    Both sides of a boundary can mint the same id without coordination —
    the producer stamps ``edge=edge(rid, hop)``, the consumer stamps
    ``cause=edge(rid, hop)`` — and replays stay byte-identical because no
    global counter is involved.  `i` disambiguates a hop a request crosses
    more than once (e.g. one edge per shipped KV page).
    """
    return f"{int(rid)}:{hop}" if i == 0 else f"{int(rid)}:{hop}#{int(i)}"


def edge_rid(edge_id: str) -> Optional[int]:
    """The request id an edge id belongs to (None if unparseable)."""
    head, _, _ = str(edge_id).partition(":")
    try:
        return int(head)
    except ValueError:
        return None


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
    """Bind the requests riding the current communication epoch; the sync
    plane stamps them onto flush/fence events for wait attribution."""
    tok = _EPOCH_RIDS.set(tuple(sorted(int(r) for r in rids)))
    try:
        yield
    finally:
        _EPOCH_RIDS.reset(tok)


def current_epoch_rids() -> tuple:
    return _EPOCH_RIDS.get()


# ======================================================================
# DAG reassembly
# ======================================================================
@dataclasses.dataclass
class RequestDAG:
    """One request's events, stitched into a happens-before DAG.

    ``nodes`` are indices into ``events`` (the per-request slice, in
    stable trace order); ``edges`` are (producer, consumer) index pairs.
    """

    rid: int
    events: list
    edges: list

    def ranks(self) -> list:
        return sorted({ev["rank"] for ev in self.events})

    def t0(self) -> int:
        return min(ev["ts"] for ev in self.events)

    def t_end(self) -> int:
        return max(ev["ts"] + ev.get("dur", 0) for ev in self.events)

    def wall(self) -> int:
        """Total elapsed from first to last event (the DAG's wall time)."""
        return self.t_end() - self.t0()

    def preds(self, i: int) -> list:
        return [a for (a, b) in self.edges if b == i]

    def succs(self, i: int) -> list:
        return [b for (a, b) in self.edges if a == i]

    def connected(self) -> bool:
        """Weak connectivity — the acceptance criterion: every event of a
        completed request reachable from every other via stitched edges."""
        n = len(self.events)
        if n <= 1:
            return True
        adj: dict[int, list] = {i: [] for i in range(n)}
        for a, b in self.edges:
            adj[a].append(b)
            adj[b].append(a)
        seen = {0}
        stack = [0]
        while stack:
            for j in adj[stack.pop()]:
                if j not in seen:
                    seen.add(j)
                    stack.append(j)
        return len(seen) == n

    def find(self, name: str) -> Optional[int]:
        for i, ev in enumerate(self.events):
            if ev["name"] == name:
                return i
        return None


def _stable_events(events: Sequence[dict]) -> list:
    """Trace order is already deterministic; sort by (ts, insertion) so
    program-order chaining is well-defined even for equal timestamps."""
    return sorted(range(len(events)), key=lambda i: (events[i]["ts"], i))


def build_dags(events: Sequence[dict]) -> dict:
    """Reassemble a flat event list into per-request DAGs.

    Any event whose args carry a ``rid`` (or an ``edge``/``cause`` id that
    parses to one) joins that request's DAG.  Explicit edges join producer
    ``edge=E`` to every consumer ``cause=E``; program order chains
    same-(rid, rank) events in time order.  Accepts `Tracer.events` or the
    event list of an exported chrome trace.
    """
    per_rid: dict[int, list] = {}
    for i in _stable_events(events):
        ev = events[i]
        args = ev.get("args", {})
        rid = args.get("rid")
        if rid is None:
            for key in ("edge", "cause"):
                if key in args:
                    rid = edge_rid(args[key])
                    if rid is not None:
                        break
        if rid is None:
            continue
        per_rid.setdefault(int(rid), []).append(ev)

    dags: dict[int, RequestDAG] = {}
    for rid, evs in per_rid.items():
        producers: dict[str, int] = {}
        for i, ev in enumerate(evs):
            e = ev.get("args", {}).get("edge")
            if e is not None and e not in producers:
                producers[e] = i
        edges: list = []
        for i, ev in enumerate(evs):
            c = ev.get("args", {}).get("cause")
            # forward-only (producer strictly earlier in stable order), so
            # the stitched graph is acyclic by construction
            if c is not None and c in producers and producers[c] < i:
                edges.append((producers[c], i))
        # program order per rank (events are already time-ordered)
        last_on_rank: dict[int, int] = {}
        for i, ev in enumerate(evs):
            r = ev["rank"]
            if r in last_on_rank:
                edges.append((last_on_rank[r], i))
            last_on_rank[r] = i
        dags[rid] = RequestDAG(rid=rid, events=evs,
                               edges=sorted(set(edges)))
    return dags
