"""The port's rendezvous transport model and its host-side contracts, in one
process (no JAX): the H100 transfer model's regimes and its exact bisected
crossovers, `resolve_transport` and the `"auto"` engine, the config
validation, and the pull-side pin/unpin liveness contract.

The crossovers are the H100 model's own: a kernel launch here costs ~10 µs
against a TPU hop's ~1 µs, so they sit far from the reference's and no test
compares the two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.perfmodel import DEFAULT_MODEL, H100, HardwareSpec, PerfModel  # noqa: E402
from repro_torch.parallel.overlap import CollectiveStrategist  # noqa: E402
from repro_torch.rmem.heap import HeapError, HostPagePool  # noqa: E402
from repro_torch.serve.disagg import (  # noqa: E402
    DisaggConfig, DisaggEngine, resolve_transport)
from repro_torch.serve.engine import DrainError  # noqa: E402

MiB = 2**20


def _cfg(**kw):
    base = dict(n_prefill=2, block_tokens=8, d_model=16, vocab=64,
                queue_capacity=8, max_recv_per_step=2, n_lanes=1, flow=True)
    base.update(kw)
    return DisaggConfig(**base)


# ------------------------------------------------- the H100 transfer model
def test_rendezvous_slope_is_flatter():
    """Eager pays two bounce passes a byte more than the pull, so the cost
    gap grows with the block."""
    m = DEFAULT_MODEL
    gap = [m.p_append_eager(b) - m.p_append_rendezvous(b, 16)
           for b in (MiB, 16 * MiB, 256 * MiB)]
    assert gap[0] < gap[1] < gap[2]


def test_three_regimes_at_ppb16():
    m = DEFAULT_MODEL
    for b in (1024, 2 * MiB, 16 * MiB):
        assert m.select_transfer_protocol(b, 16) == "eager", b
    for b in (64 * MiB, 256 * MiB):
        assert m.select_transfer_protocol(b, 16) == "rendezvous", b
    assert m.select_transfer_protocol(2**30, 16) == "paged"


def test_high_reuse_prefers_paged():
    m = DEFAULT_MODEL
    assert m.select_transfer_protocol(256 * MiB, 16, 0.0) == "rendezvous"
    assert m.select_transfer_protocol(256 * MiB, 16, 0.9) == "paged"


@pytest.mark.parametrize("ppb", [4, 8, 16, 64, 128])
def test_rendezvous_crossover_flip_exact(ppb):
    """One tol either side of the returned byte count, the pairwise
    eager-vs-rendezvous winner flips."""
    m = DEFAULT_MODEL
    b = m.rendezvous_crossover_bytes(ppb, tol=1.0)
    assert 8.0 < b < 2**30                    # interior: a real crossover
    assert m.p_append_rendezvous(b - 2, ppb) > m.p_append_eager(b - 2)
    assert m.p_append_rendezvous(b + 2, ppb) <= m.p_append_eager(b + 2)


@pytest.mark.parametrize("block_bytes,ppb", [(16 * 1024, 4), (256 * 1024, 16),
                                             (2 * MiB, 128), (64 * MiB, 16)])
def test_paged_crossover_reuse_flip_exact(block_bytes, ppb):
    m = DEFAULT_MODEL
    f = m.paged_crossover_reuse(block_bytes, ppb)
    assert 0.0 < f < 1.0
    eps = 1e-5
    assert m.select_kv_transport(block_bytes, ppb, f - eps) == "inline"
    assert m.select_kv_transport(block_bytes, ppb, f + eps) == "paged"


def test_paged_never_wins_for_tiny_blocks():
    # a page table of 16 entries costs more than a 64-byte payload
    assert DEFAULT_MODEL.paged_crossover_reuse(64.0, 16) == 1.0


def test_crossover_moves_with_the_launch_cost():
    """The crossover is the launch cost priced against the bounce bytes:
    halving the launch latency halves it (up to the descriptor bytes)."""
    slow = DEFAULT_MODEL.rendezvous_crossover_bytes(16)
    fast = PerfModel(HardwareSpec(launch_latency=H100.launch_latency / 2)
                     ).rendezvous_crossover_bytes(16)
    assert fast == pytest.approx(slow / 2, rel=1e-3)


def test_transfer_plan_surfaces_model():
    plan = CollectiveStrategist().transfer_plan(64 * MiB, 16, 0.0)
    assert plan["protocol"] == "rendezvous"
    assert plan["rendezvous_s"] < plan["eager_s"]
    assert plan["crossover_bytes"] == DEFAULT_MODEL.rendezvous_crossover_bytes(16)
    assert set(plan) == {"protocol", "eager_s", "rendezvous_s", "paged_s",
                         "crossover_bytes"}
    s = CollectiveStrategist()
    assert s.sync_plan(2, 131072) == "pscw" and s.sync_plan(2, 8) == "fence"
    assert s.aggregation_plan(16, 8.0) == "direct"


# ------------------------------------------------------- auto-selection
def test_explicit_passthrough():
    assert resolve_transport(_cfg(transport="eager")) == "eager"
    assert resolve_transport(_cfg(transport="rendezvous")) == "rendezvous"


def test_auto_small_block_stays_eager():
    cfg = _cfg(transport="auto", page_tokens=4)
    assert cfg.block_nbytes < DEFAULT_MODEL.rendezvous_crossover_bytes(
        cfg.pages_per_block)
    assert resolve_transport(cfg) == "eager"
    eng = DisaggEngine(4, cfg, device="cpu")
    assert (eng.transport_selected, eng.mode) == ("eager", "inline")
    assert eng.msg_stats["wire_msgs_per_step"] == 2


def test_auto_large_block_pulls_and_high_reuse_pages():
    big = dict(transport="auto", block_tokens=65536, d_model=128,
               page_tokens=4096, pool_pages=64)          # 64 MiB blocks
    cfg = _cfg(**big)
    assert cfg.block_nbytes > DEFAULT_MODEL.rendezvous_crossover_bytes(
        cfg.pages_per_block)
    assert resolve_transport(cfg) == "rendezvous"
    assert resolve_transport(_cfg(**{**big, "expected_reuse": 0.9})) == "paged"


def test_resolve_transport_takes_a_model():
    cfg = _cfg(transport="auto", page_tokens=4)
    cheap = PerfModel(HardwareSpec(launch_latency=0.0, event_latency=0.0))
    assert resolve_transport(cfg, model=cheap) == \
        cheap.select_transfer_protocol(cfg.block_nbytes, cfg.pages_per_block)


@pytest.mark.parametrize("kw,match", [
    (dict(transport="pull"), "transport must be"),
    (dict(transport="auto", expected_reuse=-0.1), "expected_reuse"),
    (dict(transport="rendezvous", flow=False), "credit flow control"),
    (dict(transport="auto", paged=True, page_tokens=4), "exclusive"),
])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        _cfg(**kw)


def test_rendezvous_engine_checks_its_pool():
    with pytest.raises(ValueError, match="page_tokens"):
        DisaggEngine(4, _cfg(transport="rendezvous", page_tokens=3), device="cpu")
    with pytest.raises(ValueError, match="pool_pages"):
        DisaggEngine(4, _cfg(transport="rendezvous", page_tokens=2, pool_pages=3),
                     device="cpu")


# ------------------------------------------------- the rendezvous engine
def _rdv_engine(**kw):
    eng = DisaggEngine(4, _cfg(transport="rendezvous", page_tokens=4,
                               pool_pages=16, **kw), seed=5, device="cpu")
    rng = np.random.default_rng(1)
    prompts = {i: rng.integers(0, 64, 8) for i in range(6)}
    for rid, toks in prompts.items():
        eng.submit(rid, toks)
    return eng, prompts


def test_prefill_ranks_own_the_pools():
    eng, _ = _rdv_engine()
    assert eng.kv.owners == [0, 1]
    assert eng.channel.lanes[0].kind == "descriptor"


def test_drain_reasons_name_the_pending_pull():
    """A descriptor published but not yet pulled is stuck on "pull"."""
    eng, _ = _rdv_engine(max_recv_per_step=1, n_prefill=3)
    with pytest.raises(DrainError) as ei:
        eng.run_until_drained(max_steps=3)
    reasons = ei.value.reasons
    assert "pull" in reasons.values()
    assert all(reasons[rid] == "pull" for rid in eng._pins if rid in reasons)
    assert eng._stalled == {}


def test_cancel_rolls_back_and_the_rest_drains():
    eng, prompts = _rdv_engine(max_recv_per_step=1, n_prefill=3)
    pending = eng._pending[-1][0]
    assert eng.cancel(pending)                     # still queued
    eng.step()
    eng.step()
    pinned = sorted(eng._pins)
    assert pinned
    assert eng.cancel(pinned[0])                   # published, holding pins
    assert not eng.cancel(999)
    assert eng.kv.conservation()["ok"]
    res = eng.run_until_drained()
    assert set(res) == set(prompts) - {pinned[0], pending}
    assert all(res[r] == eng.reference(prompts[r]) for r in res)
    rs = eng.rendezvous_stats()
    assert rs["pins_outstanding"] == 0 and rs["ring_payload_appends"] == 0
    assert all(c["live"] == 0 for c in eng.kv.conservation()["per_owner"].values())


# ------------------------------------------------------- pin/unpin liveness
def test_pin_holds_page_live_until_unpin():
    pool = HostPagePool(4, page_words=2, name="pintest")
    idx = pool.alloc()
    tag = pool.pin(idx)
    assert pool.tag_valid(idx, tag)
    pool.release(idx)                  # the producer drops its ref
    assert pool.live_count() == 1      # the pin keeps the page alive
    assert pool.tag_valid(idx, tag)    # generation unchanged: no reuse
    assert pool.unpin(idx, tag)        # last ref: the unpin frees
    assert pool.live_count() == 0
    assert pool.conservation()["free_plus_live"] == pool.n_pages


def test_stale_tag_unpin_raises():
    pool = HostPagePool(4, page_words=2, name="pintest2")
    idx = pool.alloc()
    tag = pool.pin(idx)
    pool.unpin(idx, tag)
    pool.release(idx)                  # freed: the generation advances
    idx2 = pool.alloc()                # same slot, new generation
    assert idx2 == idx and not pool.tag_valid(idx, tag)
    with pytest.raises(HeapError, match="stale tag"):
        pool.unpin(idx, tag)
    pool.release(idx2)


def test_pin_dead_page_raises():
    pool = HostPagePool(2, name="pintest3")
    idx = pool.alloc()
    pool.release(idx)
    with pytest.raises(HeapError, match="dead page"):
        pool.pin(idx)
