"""The port's example drivers (`repro_torch.examples`), each run on the CPU
through its `main` with its own self-checks, which raise on failure.

`disagg_serve`'s protocol counts do not depend on the weights, so they
must equal what the reference example (`examples/disagg_serve.py`) prints
on 4 forced host devices, pinned here: 16 prefix hits, 32 novel pages, 12
descriptors of 384 B, no payload ring slot, 48 pulled pages (49,152 B), no
retry, and bytes on the wire a request of 8274 inline, 5677 paged and
66,084 rendezvous.  (Under jax releases after 0.4.37 the reference engine
needs the `shard_map` shim of `tests/test_torch_disagg.py` to run.)
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (  # noqa: E402
    disagg_serve, fft3d, hashtable_kv, milc_stencil, moe_dsde)

CPU = ["--device", "cpu"]
REFERENCE_DISAGG = {"prefix_hits": 16, "novel_pages": 32, "descriptors": 12,
                    "pulled_pages": 48, "ring_payload_appends": 0, "retries": 0}


def test_disagg_serve_counts_equal_the_reference_example(capsys):
    out = disagg_serve.main(CPU)
    assert out["agree"] == disagg_serve.N_REQUESTS
    assert {k: out[k] for k in REFERENCE_DISAGG} == REFERENCE_DISAGG
    text = capsys.readouterr().out
    wire = dict(re.findall(r"\[(\w+)\] served 12 requests .* bytes_wire/req = (\d+)", text))
    assert wire == {"inline": "8274", "paged": "5677", "rendezvous": "66084"}
    assert "rendezvous: 12 descriptors (384 B) through the ring, 0 payload ring slots, " \
           "48 pages pulled by the decoders (49152 B as one-sided gets)" in text
    assert "decode == single-host reference (all 3 modes): 12/12" in text


def test_hashtable_kv_finds_every_key():
    out = hashtable_kv.main(CPU)
    assert out == {"hits": 512, "keys": 512, "dropped": 0}


def test_milc_stencil_picks_the_cards_sync_mode_and_agrees():
    """At the reference's 8 ranks the H100 model picks the fence (the TPU
    model picks PSCW there); past the card's crossover, PSCW."""
    out = milc_stencil.main(CPU)
    assert out["sync"] == "fence" and out["sync_past_crossover"] == "pscw"
    assert out["max_err"] < milc_stencil.TOL


def test_milc_stencil_past_the_crossover_picks_pscw():
    out = milc_stencil.main(CPU + ["--ranks", str(milc_stencil.PSCW_P)])
    assert out["sync"] == "pscw" and out["max_err"] < milc_stencil.TOL


def test_moe_dsde_conserves_tokens():
    out = moe_dsde.main(CPU)
    assert out["routed"] == out["pairs"] == 512
    assert out["p99_err"] < moe_dsde.TOL


def test_fft3d_matches_fftn():
    assert fft3d.main(CPU)["rel_err"] < fft3d.TOL


def test_hashtable_kv_runs_one_rank_a_process(capsys):
    out = hashtable_kv.main(CPU + ["--procs", "4"])
    assert out == {"hits": 256, "keys": 256, "dropped": 0}
    assert "4 processes: every rank's volume and answers equal its rows of the stacked " \
           "run" in capsys.readouterr().out


def test_moe_dsde_runs_one_rank_a_process(capsys):
    out = moe_dsde.main(CPU + ["--procs", "4"])
    assert out["routed"] == out["pairs"] == 256 and out["p99_err"] < moe_dsde.TOL
    assert "4 processes: every rank's combined tokens equal its rows of the stacked " \
           "run" in capsys.readouterr().out


def test_fft3d_runs_one_rank_a_process(capsys):
    assert fft3d.main(CPU + ["--procs", "4"])["rel_err"] < fft3d.TOL
    assert "4 processes: every rank's slab equals its row of the stacked run" \
        in capsys.readouterr().out


@pytest.mark.parametrize("mod", [disagg_serve, hashtable_kv, milc_stencil, moe_dsde, fft3d])
def test_default_device_is_the_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="no CUDA device"):
        mod.main([])
