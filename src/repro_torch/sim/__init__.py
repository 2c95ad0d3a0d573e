"""repro_torch.sim: deterministic simulated fabric for protocol conformance runs.

* `sim.fabric`  — `SimFabric`, a virtual-time chaos transport implementing
  the `repro_torch.core.fabric.Fabric` interface (seeded per-link delay, bounded
  reordering, duplication with receiver dedup, drop with retransmit, and
  fault-injection modes that *break* transport guarantees on purpose).
* `sim.sched`   — virtual clock + seeded run-to-quiescence scheduler over
  N simulated ranks as cooperative generator tasks.
* `sim.conformance` — runs the existing host protocol state machines
  (queue, flow, heap, paged-KV + elastic membership, epoch ordering,
  locks) at 256+ simulated ranks under chaos schedules, asserting the
  global invariants after every simulated step.  Failures reproduce from
  their reported ``(seed, schedule)`` pair.
"""
