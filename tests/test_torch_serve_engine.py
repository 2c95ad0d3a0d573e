"""The port's continuous-batching `ServeEngine` against the JAX reference.

Traffic of the reference's own engine tests (`tests/test_training.py:113-155`)
on the smollm-360m SMOKE config, from the reference's params cast to f32 (so
that tokens can be held exact across XLA-CPU and torch-CPU; the cache stays
bf16): one request against a hand-rolled prefill + decode, and five
equal-length requests through two slots.  Every token must equal the
reference's.

The reference decodes every lane at ``slot_pos.max()``
(`serve/engine.py:266`), free lanes included, so a lane behind the furthest
one decodes at the wrong RoPE position over a gap of zero keys (ROADMAP §3).
It shows even on the equal-length traffic: the fifth request is served
beside a free lane whose stale position is 3 ahead of it, and its tokens
differ from its solo run.  The port keeps one position a lane; its engine
is held to the reference engine wherever the reference engine agrees with
its own solo runs, and to the solo runs everywhere, including the
unequal-length cases (``[3, 1, 4, 1, 5]`` beside ``[9, 2]``, and a seeded
mix of lengths 2-9 through three slots) that only the port gets right.

The jamba (hybrid) and qwen3-moe (moe) SMOKE engines are held to their
own solo runs, and a lane recycled from a long request to a short one to
the short request's solo tokens (the engine resets a lane's recurrent state
to `init_cache`'s before its prefill).

The lock discipline (`tests/test_training.py:191-260`) is held with a torch
stub model: a recycle under the reader lock raises, threaded submitters
against the scheduler finish every request exactly once with the window
released, and `DrainError` names exactly the undrained ids.  The reference
runs in a child process through this file's own ``__main__`` branch.
"""

import contextlib
import io
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    DrainError, LockDisciplineError, Request, ServeEngine)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCH = "smollm-360m"
DIRECT = dict(prompt=[3, 1, 4, 1, 5], n_new=6, slots=2, max_seq=64)
INTERLEAVE = dict(prompts=[[1 + i, 2 + i] for i in range(5)], max_new=4, slots=2,
                  max_seq=32)
UNEQUAL = dict(prompts=[[9, 2], [3, 1, 4, 1, 5]], max_new=5, slots=2, max_seq=32)
MIX = dict(n=10, max_new=6, slots=3, max_seq=32)


def _mix_prompts(vocab: int) -> list:
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, int(rng.integers(2, 10))).tolist()
            for _ in range(MIX["n"])]


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine

    cfg = jget(ARCH, smoke=True)
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    out = {f"param/{k}": np.asarray(v.astype(jnp.float32))
           for k, v in _flat(params).items()}
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)

    def solo(prompt, n_new, max_seq):
        cache = model.init_cache(1, max_seq)
        logits, cache = prefill(p32, jnp.asarray([prompt], jnp.int32), cache)
        toks = []
        for _ in range(n_new):
            tok = jnp.argmax(logits, -1)
            toks.append(int(tok[0]))
            logits, cache = decode(p32, tok, cache)
        return toks

    def engine(prompts, max_new, slots, max_seq):
        eng = JEngine(model, p32, n_slots=slots, max_seq=max_seq)
        reqs = [JRequest(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return np.array([r.output for r in reqs])

    out["direct_solo"] = np.array(solo(DIRECT["prompt"], DIRECT["n_new"], DIRECT["max_seq"]))
    out["direct_engine"] = engine([DIRECT["prompt"]], DIRECT["n_new"], DIRECT["slots"],
                                  DIRECT["max_seq"])[0]
    for tag, case in (("interleave", INTERLEAVE), ("unequal", UNEQUAL)):
        out[f"{tag}_engine"] = engine(case["prompts"], case["max_new"], case["slots"],
                                      case["max_seq"])
        out[f"{tag}_solo"] = np.array([solo(p, case["max_new"], case["max_seq"])
                                       for p in case["prompts"]])
    out["mix_solo"] = np.array([solo(p, MIX["max_new"], MIX["max_seq"])
                                for p in _mix_prompts(cfg.vocab_size)])
    np.savez(d / "out.npz", **out)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_engine_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def port(reference):
    flat = {k[len("param/"):]: v for k, v in reference.items() if k.startswith("param/")}
    model = build_model(get_config(ARCH, smoke=True))
    return model, params_from_jax(_tree(flat), device="cpu", dtype=torch.float32)


def _engine_run(port, prompts, max_new, slots, max_seq):
    model, params = port
    eng = ServeEngine(model, params, n_slots=slots, max_seq=max_seq, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained() >= 1
    assert all(r.done.is_set() and len(r.output) == max_new for r in reqs)
    assert eng.queue.empty() and all(eng.slot_free)
    # the lock window is fully released after a drain
    assert eng.lock_win.total_amos > 0
    assert eng.lock_win.master.v == 0 and all(w.v == 0 for w in eng.lock_win.local)
    return [r.output for r in reqs]


def _solo(port, prompt, n_new, max_seq):
    model, params = port
    cache = model.init_cache(1, max_seq, device="cpu")
    logits, cache = model.prefill(params, torch.tensor([prompt]), cache)
    toks = []
    for _ in range(n_new):
        tok = torch.argmax(logits, -1)
        toks.append(int(tok[0]))
        logits, cache = model.decode_step(params, tok, cache)
    return toks


# ----------------------------------------------------- the reference's traffic
def test_engine_matches_direct_decode(reference, port):
    got = _engine_run(port, [DIRECT["prompt"]], DIRECT["n_new"], DIRECT["slots"],
                      DIRECT["max_seq"])[0]
    want = reference["direct_solo"].tolist()
    assert _solo(port, DIRECT["prompt"], DIRECT["n_new"], DIRECT["max_seq"]) == want
    assert got == want == reference["direct_engine"].tolist()


def test_engine_interleaves_requests(reference, port):
    case = INTERLEAVE
    got = _engine_run(port, case["prompts"], case["max_new"], case["slots"], case["max_seq"])
    solo, ref_eng = reference["interleave_solo"].tolist(), reference["interleave_engine"].tolist()
    assert got == solo
    agree = [i for i in range(len(solo)) if ref_eng[i] == solo[i]]
    assert agree == [0, 1, 2, 3]          # the fifth decodes beside a stale free lane
    assert [got[i] for i in agree] == [ref_eng[i] for i in agree]


# -------------------------------------------------- per-lane positions (port)
def test_unequal_lengths_each_equal_their_solo_run(reference, port):
    case = UNEQUAL
    got = _engine_run(port, case["prompts"], case["max_new"], case["slots"], case["max_seq"])
    solo = reference["unequal_solo"].tolist()
    assert got == solo
    assert got == [_solo(port, p, case["max_new"], case["max_seq"]) for p in case["prompts"]]
    # the reference's shared position: the shorter prompt goes wrong
    assert reference["unequal_engine"].tolist()[0] != solo[0]
    assert reference["unequal_engine"].tolist()[1] == solo[1]


def test_random_length_mix_through_three_slots(reference, port):
    prompts = _mix_prompts(get_config(ARCH, smoke=True).vocab_size)
    assert len({len(p) for p in prompts}) > 3
    got = _engine_run(port, prompts, MIX["max_new"], MIX["slots"], MIX["max_seq"])
    assert got == reference["mix_solo"].tolist()


def test_bf16_params_engine_equals_port_solo_runs():
    """The port's own bf16 weights (as the card runs them): each request of
    an unequal-length batch equals its own solo run."""
    model = build_model(get_config(ARCH, smoke=True))
    params = model.init(5, device="cpu")
    prompts = UNEQUAL["prompts"] + [[7, 7, 7]]
    got = _engine_run((model, params), prompts, 4, 2, 32)
    assert got == [_solo((model, params), p, 4, 32) for p in prompts]


# ------------------------------------------- the moe and hybrid families
NEW_FAMILIES = ("jamba-v0.1-52b", "qwen3-moe-30b-a3b")


def _f32_port(arch, seed):
    """The port's own weights cast to f32, so that a lane decoded beside
    others and the same request alone agree to f32 rounding (the cache and
    the Mamba conv window stay bf16)."""
    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    model = build_model(get_config(arch, smoke=True))
    return model, f32(model.init(seed, device="cpu"))


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_moe_and_hybrid_engines_equal_their_solo_runs(arch):
    """A seeded mix of prompt lengths 2-9 through three lanes: every
    request equals its own solo run (Jamba: the Mamba state rides the lane;
    qwen3-moe: the MoE routes the lanes' tokens as one dispatch group)."""
    port = _f32_port(arch, 5)
    prompts = _mix_prompts(get_config(arch, smoke=True).vocab_size)
    got = _engine_run(port, prompts, MIX["max_new"], MIX["slots"], MIX["max_seq"])
    assert got == [_solo(port, p, MIX["max_new"], MIX["max_seq"]) for p in prompts]


def test_recycled_lane_starts_from_a_zero_state():
    """One lane serves a long request, then a short one: the short one's
    tokens are its solo run's, because the engine zeroes the lane's Mamba
    state (h and the conv window) before the prefill; left as the long
    request and the free lane's decode steps made it, the state would seed
    the short request's scan."""
    port = _f32_port("jamba-v0.1-52b", 6)
    rng = np.random.default_rng(12)
    long, short = rng.integers(0, 256, 24).tolist(), [5, 9, 2]
    got = _engine_run(port, [long, short], 6, 1, 48)
    assert got[0] == _solo(port, long, 6, 48)
    assert got[1] == _solo(port, short, 6, 48)


# ----------------------------------------------------------- lock discipline
class _StubServeModel:
    """Token t always produces (t + 1) % vocab; its cache has the [B, ...]
    leaf layout a real KV cache has, so the lane views are exercised."""

    vocab = 17

    def init_cache(self, b, max_seq, device=None):
        return {"k": torch.zeros(b, max_seq, 4, device=device),
                "len": torch.zeros((), dtype=torch.int32, device=device)}

    def _next(self, last):
        return torch.nn.functional.one_hot((last.long() + 1) % self.vocab, self.vocab).float()

    def prefill(self, params, tokens, cache, _):
        cache["k"][:, : tokens.shape[1]] = tokens[..., None].float()
        return self._next(tokens[:, -1]), cache

    def decode_step(self, params, tokens, cache):
        return self._next(tokens), cache


def _stub_engine(n_slots=3):
    return ServeEngine(_StubServeModel(), {}, n_slots=n_slots, max_seq=32, device="cpu")


def test_recycle_under_reader_lock_raises():
    eng = _stub_engine()
    req = Request(rid=0, prompt=[1], max_new=1)
    eng.slot_free[0] = False
    eng.slot_req[0] = req
    with pytest.raises(LockDisciplineError):
        eng._recycle(0)                      # no lock at all
    eng.lock.lock_shared(0)
    try:
        with pytest.raises(LockDisciplineError):
            eng._recycle(0)                  # under the reader lock
    finally:
        eng.lock.unlock_shared(0)
    assert not req.done.is_set()             # the refused paths did nothing
    with eng.lock.exclusive(0):
        eng._recycle(0)                      # writer-locked: legal
    assert req.done.is_set() and eng.slot_free[0]
    assert eng.lock_win.master.v == 0
    assert all(w.v == 0 for w in eng.lock_win.local)


def test_prefill_writes_its_lane_in_place():
    eng = _stub_engine(n_slots=3)
    eng.submit(Request(rid=0, prompt=[4, 5, 6], max_new=3))
    eng.submit(Request(rid=1, prompt=[9], max_new=3))
    eng.admit()
    k = eng.cache["k"]
    assert k[0, :3].tolist() == [[4.0] * 4, [5.0] * 4, [6.0] * 4]
    assert k[1, 0].tolist() == [9.0] * 4 and not k[1, 1:].any() and not k[2].any()
    assert eng.slot_pos.tolist() == [3, 1, 0]


def test_threaded_submitters_vs_scheduler():
    """Request threads admit (shared-lock prefills, exclusive-lock
    allocations and recycles) while a scheduler thread runs the unified
    tick.  Every request finishes exactly once with the right tokens and
    the lock window comes back fully released."""
    eng = _stub_engine(n_slots=3)
    vocab = _StubServeModel.vocab
    reqs = [Request(rid=i, prompt=[(i % 13) + 1], max_new=1 if i % 5 == 0 else 3)
            for i in range(24)]
    stop = threading.Event()
    errors = []

    def scheduler():
        try:
            while not stop.is_set():
                eng.schedule()
        except Exception as e:  # pragma: no cover - surfaced by the assert
            errors.append(e)

    def submitter(chunk):
        try:
            for r in chunk:
                eng.submit(r)
                eng.admit()      # request threads run admission themselves
        except Exception as e:  # pragma: no cover - surfaced by the assert
            errors.append(e)

    sched = threading.Thread(target=scheduler)
    subs = [threading.Thread(target=submitter, args=(reqs[i::3],)) for i in range(3)]
    sched.start()
    for t in subs:
        t.start()
    for t in subs:
        t.join(timeout=120)
    done = all(r.done.wait(timeout=120) for r in reqs)
    stop.set()
    sched.join(timeout=120)
    assert not errors, errors
    assert done
    for r in reqs:
        first = r.prompt[0]
        want = [(first + 1 + j) % vocab for j in range(r.max_new)]
        assert r.output == want, (r.rid, r.output, want)
    assert eng.recycled_total == len(reqs)
    assert all(eng.slot_free)
    assert eng.lock_win.master.v == 0
    assert all(w.v == 0 for w in eng.lock_win.local)


def test_drain_timeout_raises_with_the_exact_undrained_ids():
    eng = _stub_engine(n_slots=2)
    for i in range(3):
        eng.submit(Request(rid=10 + i, prompt=[1], max_new=8))
    with pytest.raises(DrainError) as ei:
        eng.run_until_drained(max_steps=1)
    assert ei.value.undrained == (10, 11, 12)    # two in lanes, one queued
    assert "[10, 11, 12]" in str(ei.value)
    assert eng.lock_win.master.v == 0 and all(w.v == 0 for w in eng.lock_win.local)


def test_schedule_tick_counts():
    eng = _stub_engine(n_slots=2)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[i], max_new=2))
    tick = eng.schedule()
    assert (tick.admitted, tick.emitted, tick.recycled) == (2, 2, 2)
    assert eng.schedule() == (1, 1, 1)
    assert eng.serve_metrics()["ttft_us"]["count"] == 3
    assert eng.serve_metrics()["tbt_us"]["count"] == 3


# --------------------------------------------------------------- the launcher
def test_launch_serve_jamba_with_a_depth_cut_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                           "--layers", "8", "--requests", "3", "--max-new", "3"])
    text = buf.getvalue()
    assert "3 requests, 9 tokens" in text and "device cpu" in text
    with pytest.raises(SystemExit, match="whole periods"):
        launch_serve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
                           "--layers", "4"])


def test_launch_serve_smoke_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--smoke", "--device", "cpu", "--requests", "5",
                           "--max-new", "4", "--slots", "2"])
    text = buf.getvalue()
    assert "5 requests, 20 tokens" in text and "device cpu" in text
    assert text.count("req ") == 4


def test_launch_serve_refuses_whisper_as_the_reference_launcher_does():
    with pytest.raises(SystemExit, match="serve demo targets decoder-only archs"):
        launch_serve.main(["--arch", "whisper-small", "--smoke", "--device", "cpu"])


def test_launch_serve_xlstm_smoke_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-new", "3", "--slots", "2"])
    text = buf.getvalue()
    assert "3 requests, 9 tokens" in text and "device cpu" in text
    with pytest.raises(SystemExit, match="whole periods of 8"):
        launch_serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                           "--layers", "4"])


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
