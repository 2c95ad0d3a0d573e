"""Serving-engine errors shared by the engines (the `repro.serve.engine`
counterpart; the continuous-batching engine itself is a later slice)."""

from __future__ import annotations


class DrainError(RuntimeError):
    """`run_until_drained` exhausted `max_steps` with work still queued.

    `reasons` maps each undrained rid to why it is stuck — ``"credit"``
    (deferred on a dry credit window), ``"pool"`` (page pool dry) or
    ``"queue"`` (never left the pending queue)."""

    def __init__(self, message: str, undrained: tuple,
                 reasons: dict | None = None):
        detail = f"{message}; undrained request ids: {list(undrained)}"
        if reasons:
            detail += "; stall reasons: " + ", ".join(
                f"{rid}={reasons[rid]}" for rid in undrained if rid in reasons)
        super().__init__(detail)
        self.undrained = tuple(undrained)
        self.reasons = dict(reasons or {})
