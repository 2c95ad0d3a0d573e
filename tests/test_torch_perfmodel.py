"""The H100 perf model's choices and roofline terms (`repro_torch.core.
perfmodel`) against the reference's `repro.core.perfmodel`, in-process.

The reference's flow, put-backend and roofline assertions
(`tests/test_flow.py:127-159`, `tests/test_plan.py:272-275`,
`tests/test_core_protocols.py:225-235`) replayed on the port's model.  The
card's prices change some answers: where they do, the test says so and
asserts the card's answer.  The pure arithmetic (`expected_rejects`, and
`roofline_terms`' compute and memory terms under V5E's two rates) must
equal the reference's.
"""

import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

from repro.core import perfmodel as ref  # noqa: E402
from repro_torch.core import perfmodel as pm  # noqa: E402
from repro_torch.core.perfmodel import DEFAULT_MODEL as M  # noqa: E402
from repro_torch.core.perfmodel import H100, HardwareSpec, PerfModel, roofline_terms  # noqa: E402

from .helpers import given, settings, st  # noqa: E402

# a spec carrying V5E's compute and memory rates (and its ICI link as the
# copy rate), for the terms that must equal the reference's
V5E_RATES = dataclasses.replace(H100, peak_flops_bf16=ref.V5E.peak_flops_bf16,
                                hbm_bandwidth=ref.V5E.hbm_bandwidth,
                                copy_bandwidth=ref.V5E.ici_link_bandwidth)


def _methods(cls) -> set:
    return {n for n, v in vars(cls).items() if callable(v) and not n.startswith("_")}


def test_port_has_every_reference_method():
    missing = _methods(ref.PerfModel) - _methods(PerfModel)
    assert not missing, missing
    assert callable(pm.roofline_terms)


@pytest.mark.parametrize("name", sorted(_methods(ref.PerfModel)))
def test_no_hops_argument(name):
    """The port prices one card: no method takes the reference's `hops`."""
    assert "hops" not in inspect.signature(getattr(PerfModel, name)).parameters


# ------------------------------------------------------ flow-control model
def test_fused_refresh_is_free():
    assert M.p_credit_refresh(fused=True) == 0.0
    assert M.p_credit_refresh(fused=False) > 0.0


@pytest.mark.parametrize("f", [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999999, 1.0, 1.5, -0.2])
def test_expected_rejects_equals_reference(f):
    assert M.expected_rejects(f) == ref.DEFAULT_MODEL.expected_rejects(f)


def test_credit_common_path_costs_the_credit_books():
    """The card's answer: at zero occupancy the reference prices both
    schemes alike (wire-identical); on one card the credit path also pays
    `flow_epoch_latency` an epoch, spread over its batch, which a
    rejection-free retry path does not."""
    nb = 4096.0
    credit, retry = M.p_enqueue_credit(nb, credit_batch=4), M.p_enqueue_retry(nb, 0.0)
    assert credit == pytest.approx(retry + H100.flow_epoch_latency / 4)


def test_retry_cost_grows_with_occupancy():
    nb = 1024.0
    costs = [M.p_enqueue_retry(nb, f) for f in (0.0, 0.5, 0.9, 0.99)]
    assert costs == sorted(costs) and costs[-1] > costs[0]
    assert costs[1] - costs[0] == pytest.approx(M.p_reject(nb))      # one reject at f = 0.5
    # the credit cost does not depend on the occupancy
    assert M.p_enqueue_credit(nb, 4) == M.p_enqueue_credit(nb, 4, fused=True)


def test_crossover_occupancy():
    """The card's answer: even with the fused refresh the credit books make
    credit lose at low occupancy (the reference: crossover 0), and the
    crossover moves earlier as the credit batch grows."""
    x1 = M.flow_crossover_occupancy(1024.0, 1, fused=True)
    x8 = M.flow_crossover_occupancy(1024.0, 8, fused=True)
    assert 0.0 < x8 <= x1 <= 1.0
    if x8 < 1.0:
        assert M.select_flow_control(1024.0, x8, 8) == "credit"
        assert M.select_flow_control(1024.0, max(x8 - 0.02, 0.0), 8) == "retry"
    # a standalone refresh costs more, so its crossover is no earlier
    assert M.flow_crossover_occupancy(1024.0, 8, fused=False) >= x8


# ------------------------------------------------ put backend, locks, flush
def test_put_backend_threshold():
    """The card's answer, in the port's backend names ("torch" for
    `Mesh.shift`, "cuda" for kernel row 4; the reference's "xla" and
    "pallas"): the hand kernel at every size, 64 B and MILC's 192 MiB halo
    alike (phase 27.1 measured it faster at 8 KiB and 1 MiB too).  The
    reference keeps a 64-byte put on XLA and sends 16 MiB through Pallas."""
    assert ref.DEFAULT_MODEL.select_put_backend(64.0) == "xla"
    assert ref.DEFAULT_MODEL.select_put_backend(16 << 20) == "pallas"
    for nbytes in (8.0, 64.0, 8 << 10, 1 << 20, 16 << 20, 192 << 20, 1 << 34):
        assert M.select_put_backend(nbytes) == "cuda"
    # a dearer kernel call would hand the small puts back to PyTorch
    slow = PerfModel(dataclasses.replace(H100, csrc_launch_latency=1e-3))
    assert slow.select_put_backend(64.0) == "torch"
    assert slow.select_put_backend(1 << 34) == "cuda"


def test_lock_and_flush_prices_are_the_cards():
    assert M.p_lock_excl() == H100.lock_latency > 0
    assert M.p_flush() == H100.flush_latency > 0
    assert M.p_flush() < M.p_lock_excl()


# ------------------------------------------------------ the attend path
@pytest.mark.parametrize("n_pages,page_bytes", [(128, 16 * 2 * 128 * 4),    # disagg's page
                                                (128, 128 << 10),           # the pool's
                                                (4, 8.0), (1, 64 << 20)])
def test_paged_attend_prefers_the_fused_walk(n_pages, page_bytes):
    """The card's answer: no per-message injection cost for the gather to
    amortise, so the fused walk wins at every size (the reference's
    gather wins below its ~20 KiB message-rate crossover)."""
    assert M.select_paged_attend(n_pages, page_bytes) == "fused"
    assert M.p_paged_attention(n_pages, page_bytes) < M.p_paged_gather_attend(n_pages,
                                                                              page_bytes)


def test_paged_attend_crossover():
    assert M.paged_attend_crossover_bytes() == 8.0          # fused from the first size
    assert ref.DEFAULT_MODEL.paged_attend_crossover_bytes() > 8.0


@pytest.mark.parametrize("nbytes", [8.0, 64 << 10, 64 << 20, 1 << 33])
def test_accumulate_mode_is_slotted(nbytes):
    assert M.select_accumulate_mode(nbytes, 2) == "slotted"
    assert M.p_accumulate_kernel(nbytes) < M.p_put_kernel(nbytes) * 2


# ------------------------------------------------------------ roofline
def test_roofline_terms():
    t = roofline_terms(hlo_flops=1e15, hlo_bytes=1e12, collective_bytes=1e11, chips=256)
    assert t["dominant"] == "compute_s"
    assert 0 < t["roofline_fraction"] <= 1.0
    t2 = roofline_terms(1e12, 1e13, 1e10, chips=256)
    assert t2["dominant"] == "memory_s"
    t3 = roofline_terms(1e9, 1e9, 1e12, chips=1)
    assert t3["dominant"] == "collective_s"
    assert t3["collective_s"] == pytest.approx(1e12 / H100.copy_bandwidth)


@given(st.floats(1e3, 1e18), st.floats(1e3, 1e15), st.floats(0, 1e14))
@settings(max_examples=100, deadline=None)
def test_roofline_fraction_bounded(f, b, c):
    t = roofline_terms(f, b, c, chips=512)
    assert 0.0 <= t["roofline_fraction"] <= 1.0 + 1e-9


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (1e15, 1e12, 1e11, 256), (1e12, 1e13, 1e10, 256), (3.3e17, 2e14, 0.0, 1),
    (1e9, 1e12, 0.0, 1), (0.0, 0.0, 0.0, 1), (7.1e13, 1.9e11, 4.0e9, 8)])
def test_roofline_terms_equal_reference_at_v5e_rates(flops, nbytes, coll, chips):
    mine = roofline_terms(flops, nbytes, coll, chips, hw=V5E_RATES)
    theirs = ref.roofline_terms(flops, nbytes, coll, chips)
    for key in ("compute_s", "memory_s", "collective_s", "roofline_fraction"):
        assert mine[key] == pytest.approx(theirs[key], rel=1e-12, abs=0.0)
    assert mine["dominant"] == theirs["dominant"]


def test_spec_carries_the_cards_capacity():
    assert H100.hbm_capacity == 80e9
    assert isinstance(HardwareSpec().hbm_capacity, float)
