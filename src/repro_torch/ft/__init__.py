"""Fault tolerance: heartbeat and straggler detection (`heartbeat`), and
elasticity (`elastic`: the mesh plan for survivors, the checkpoint restored
onto it, and the paged KV cache's rank leave and join)."""

from . import elastic, heartbeat  # noqa: F401

__all__ = ["elastic", "heartbeat"]
