"""The launch tools of the port: `Model.init_shapes` / `input_specs`,
`launch.hlo_cost`'s counter, `launch.roofline` and `launch.dryrun`.

One short JAX child (this file's ``__main__`` branch) writes the
reference's abstract params and input specs of every SMOKE config (names,
shapes, dtypes, by `jax.eval_shape`) and `repro.launch.hlo_cost.analyze` of
one SMOKE forward compiled on the CPU.  The port's meta tensors must equal
the former leaf for leaf; the port's counter, run on the same forward on
meta tensors, must come within `FWD_FLOPS_REL` of the latter.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost, roofline  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KINDS = ("train_4k", "prefill_32k", "decode_32k")     # the three shape kinds
FWD_ARCH, FWD_SHAPE = "smollm-360m", (2, 64)
# The port counts the eager ops of the forward; the reference parses XLA's
# optimised HLO of the same forward on the CPU.  The products are the same
# (2 x out x K a dot); the elementwise work differs: XLA fuses and
# rewrites (a softmax is a few fused reduces and maps, rsqrt and
# broadcasts fold), eager PyTorch runs every op.  At this SMOKE size the
# products are ~80 % of the count, so the totals agree within 15 %.
FWD_FLOPS_REL = 0.15


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _spec(leaf) -> list:
    return [list(leaf.shape), str(leaf.dtype).replace("torch.", "")]


# ---------------------------------------------------------- the JAX child
def _reference_child(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.tree_util import tree_flatten_with_path

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch import hlo_cost as jcost
    from repro.models.registry import build_model as jbuild

    def flat(tree):
        leaves, _ = tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", k)) for k in kp): [list(x.shape), str(x.dtype)]
                for kp, x in leaves}

    out = {"specs": {}}
    for arch in ARCH_IDS:
        model = jbuild(jget(arch, smoke=True))
        out["specs"][arch] = {"params": flat(model.init_shapes()),
                              **{k: flat(model.input_specs(JSHAPES[k])) for k in KINDS}}
    model = jbuild(jget(FWD_ARCH, smoke=True))
    params = model.init_shapes()
    tokens = jax.ShapeDtypeStruct(FWD_SHAPE, jnp.int32)
    compiled = jax.jit(lambda p, t: model.forward_logits(p, {"tokens": t}).logits).lower(
        params, tokens).compile()
    s = jcost.analyze(compiled.as_text())
    out["forward"] = {"flops": s.flops, "hbm_bytes": s.hbm_bytes}
    pathlib.Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("launch_ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(path)], capture_output=True,
                          text=True, timeout=60, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(path.read_text())


# -------------------------------------------------- init_shapes, input_specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_shapes_equal_reference(reference, arch):
    model = build_model(get_config(arch, smoke=True))
    mine = {k: _spec(v) for k, v in _flat(model.init_shapes()).items()}
    assert all(v.device.type == "meta" for v in _flat(model.init_shapes()).values())
    assert mine == reference["specs"][arch]["params"]
    assert model.param_count() == sum(
        int(torch.tensor(s).prod()) if s else 1 for s, _ in mine.values())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(reference, arch, kind):
    model = build_model(get_config(arch, smoke=True))
    specs = _flat(model.input_specs(SHAPES[kind]))
    assert all(v.device.type == "meta" for v in specs.values())
    assert {k: _spec(v) for k, v in specs.items()} == reference["specs"][arch][kind]


# ------------------------------------------------------------ the counter
def test_counter_is_exact_on_products():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    x, w = torch.randn(3, 8, 16), torch.randn(3, 16, 5)
    bias = torch.randn(4)

    def prog(a, b, x, w, bias):
        return (a @ b, torch.bmm(x, w), torch.addmm(bias, a, b),
                torch.einsum("bij,bjk->bik", x, w), torch.nn.functional.linear(a, b.T, bias))

    s = hlo_cost.analyze(prog, a, b, x, w, bias)
    mm = 2 * 8 * 4 * 16
    bmm = 2 * 3 * 8 * 5 * 16
    assert s.product_flops == 3 * mm + 2 * bmm


def test_counter_memory_and_bytes_are_exact():
    a = torch.randn(64, 32)

    def prog(a):
        t = a * 2.0                       # 8 KiB, dies after the sum
        return t.sum(0)                   # 128 B out

    s = hlo_cost.analyze(prog, a)
    assert (s.mem_args, s.mem_out, s.mem_temp) == (8192, 128, 8192)
    assert s.hbm_bytes == (8192 + 8192) + (8192 + 128)
    assert s.flops == 64 * 32 + 64 * 32      # the mul's outputs, the sum's inputs


def test_collectives_recorded_through_the_mesh():
    mesh = Mesh(4, "x", device="cpu")
    x = torch.zeros(4, 4, 6)

    def prog(x):
        mesh.all_gather(x)
        mesh.all_to_all(x)
        mesh.ppermute(x, [(0, 1), (1, 2)])
        mesh.shift(x, 1)
        mesh.psum_scatter(x)
        grid = Mesh({"pod": 2, "data": 2}, device="cpu")
        grid.psum(x.reshape(2, 2, 4, 6), "pod")

    s = hlo_cost.analyze(prog, x)
    nb = x.nbytes
    assert s.collective_bytes_by_kind() == {"all-gather": nb, "all-to-all": nb,
                                            "collective-permute": 2 * nb,
                                            "reduce-scatter": nb, "all-reduce": nb}
    assert s.collective_bytes_by_group_size() == {4: 5 * nb, 2: nb}
    assert [(c.group_size, c.groups) for c in s.collectives][-1] == (2, 2)
    # outside a counter nothing is recorded and nothing fails
    mesh.shift(x, 1)


def test_attention_scope_splits_a_train_step():
    """Backend "cuda" (on the CPU the flash wrapper's plain version, its
    backward recomputed under the wrapper's own scope) and backend "torch"
    (the blockwise attention) give the same non-attention product FLOPs."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, make_train_step

    model = build_model(get_config(FWD_ARCH, smoke=True))
    params = model.init(0, device="cpu")
    batch = {k: torch.zeros(FWD_SHAPE, dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(model, AdamWConfig(), StepConfig(remat=True))
    got = {}
    for backend in ("cuda", "torch"):
        L.set_attention_backend(backend)
        try:
            s = hlo_cost.analyze(step, params, init_opt_state(params), batch)
        finally:
            L.set_attention_backend("torch")
        got[backend] = dict(s.product_flops_by_scope)
    assert got["cuda"][""] == got["torch"][""] > 0
    assert got["cuda"]["attention"] > 0 and got["torch"]["attention"] > 0


def test_repeat_folds_a_loop_on_meta():
    """xLSTM's sLSTM and mLSTM loops fold to one trip on meta tensors:
    the prefill's FLOPs and bytes equal the unfolded CPU run's."""
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_prefill_step

    cfg = get_config("xlstm-1.3b", smoke=True)
    model = build_model(cfg)
    runs = []
    for dev in ("cpu", "meta"):
        params = T.init_lm(cfg, None, "meta") if dev == "meta" else model.init(0, device=dev)
        tokens = torch.zeros(2, 200, dtype=torch.int32, device=dev)
        runs.append(hlo_cost.analyze(make_prefill_step(model), params, {"tokens": tokens}))
    assert runs[0].flops == runs[1].flops
    assert runs[0].hbm_bytes == runs[1].hbm_bytes
    assert runs[1].n_ops < runs[0].n_ops / 5


@pytest.mark.parametrize("grad", [False, True])
def test_repeat_folds_blockwise_attention_on_meta(grad):
    """The blockwise attention's block loops fold to one block pair on meta
    tensors: FLOPs and bytes equal the unfolded CPU run's, with autograd
    (every block's saved tensors live) and without.  So does the peak
    footprint without autograd; with it the unfolded run's backward also
    holds the buffer that sums the blocks' gradients of the padded K (one
    [320, ...] f32 block, 81,920 B here), which one folded trip never makes."""
    shapes = {"q": (2, 300, 4, 16), "k": (2, 300, 2, 16)}
    slack = 2 * 320 * 2 * 16 * 4 if grad else 0

    def attend(q, k):
        with torch.set_grad_enabled(grad):
            q = q.requires_grad_(grad)
            return L.blockwise_attention(q, k, k, causal=True, block_size=64)

    runs = []
    for dev in ("cpu", "meta"):
        q, k = (torch.zeros(shp, device=dev) for shp in shapes.values())
        runs.append(hlo_cost.analyze(attend, q, k))
    cpu, meta = runs
    assert (cpu.flops, cpu.hbm_bytes) == (meta.flops, meta.hbm_bytes)
    assert cpu.mem_out == meta.mem_out
    assert cpu.mem_temp - slack <= meta.mem_temp <= cpu.mem_temp
    assert meta.n_ops < cpu.n_ops / 5


def test_scan_meta_reports_its_kernel():
    """On meta tensors under a counter the scan wrapper reports its kernel's
    counts and returns meta outputs (Mamba's path in the dry-run); nothing
    launches, and outside a counter meta is refused."""
    from repro_torch.kernels.ssm_scan import ops

    B, S, d, N = 2, 64, 8, 4
    decay = torch.empty(B, S, d, N, device="meta")
    c = torch.empty(B, S, N, device="meta")
    before = ops.launches
    s = hlo_cost.analyze(lambda a, b, c: ops.selective_scan(a, b, c)[0], decay, decay, c)
    assert s.kernel_flops["ssm_scan"] == 4 * B * S * d * N
    assert s.kernel_bytes["ssm_scan"] == (2 * B * S * d * N * 4 + B * S * N * 4
                                          + B * S * d * 4 + B * d * N * 4)
    assert ops.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.selective_scan(decay, decay, c)


def test_forward_flops_near_reference(reference):
    model = build_model(get_config(FWD_ARCH, smoke=True))
    tokens = torch.zeros(FWD_SHAPE, dtype=torch.int32, device="meta")
    s = hlo_cost.analyze(lambda p, t: model.forward_logits(p, {"tokens": t}).logits,
                         model.init_shapes(), tokens)
    want = reference["forward"]["flops"]
    assert abs(s.flops - want) <= FWD_FLOPS_REL * want, (s.flops, want)


# ------------------------------------------------------- roofline, dry-run
REC = {"arch": "smollm-360m", "shape": "train_4k", "mesh": "card", "chips": 1,
       "status": "ok", "hlo_flops": 4.92e15, "hlo_bytes": 3.23e14, "coll_bytes": 1.5e11}


@pytest.mark.parametrize("rec", [
    REC, {**REC, "hlo_bytes": 4e16}, {**REC, "coll_bytes": 8e14, "shape": "decode_32k"},
    {**REC, "status": "skipped", "reason": "full quadratic attention; long_500k skipped"},
    {**REC, "status": "FAILED", "error": "ValueError: a failing cell"}])
def test_fmt_row_matches_reference(monkeypatch, rec):
    """Under V5E's rates the port's row equals the reference's in every
    column but the advice, which speaks of the card; the advice's kind
    follows the same dominant term."""
    import dataclasses

    from repro.core import perfmodel as jpm
    from repro.launch import roofline as jroof
    from repro_torch.core import perfmodel as pm

    v5e = dataclasses.replace(pm.H100, peak_flops_bf16=jpm.V5E.peak_flops_bf16,
                              hbm_bandwidth=jpm.V5E.hbm_bandwidth,
                              copy_bandwidth=jpm.V5E.ici_link_bandwidth)
    monkeypatch.setattr(roofline, "roofline_terms",
                        lambda *a, **k: pm.roofline_terms(*a, **k, hw=v5e))
    mine, theirs = roofline.fmt_row(dict(rec)), jroof.fmt_row(dict(rec))
    assert mine.split("|")[:-2] == theirs.split("|")[:-2]
    assert roofline.HEADER == jroof.HEADER
    if rec["status"] == "ok":
        assert roofline.model_flops_total(rec["arch"], rec["shape"]) == \
            jroof.model_flops_total(rec["arch"], rec["shape"])


def test_dryrun_smoke_cells_all_ok(tmp_path, capsys):
    recs = dryrun.main(["--mesh", "card", "--smoke", "--out", str(tmp_path)])
    assert len(recs) == len(ARCH_IDS) * len(SHAPES)
    for rec in recs:
        cfg = get_config(rec["arch"], smoke=True)
        ok, _ = dryrun.shape_applicable(cfg, SHAPES[rec["shape"]])
        assert rec["status"] == ("ok" if ok else "skipped"), rec
        if ok:
            assert rec["hlo_flops"] > 0 and rec["mem_args"] > 0 and rec["fits"] in (True, False)
            assert rec["n_params"] == build_model(cfg).param_count()
    rows = roofline.main(["--dir", str(tmp_path)])
    assert len(rows) == 1 + len(recs)
    assert "FAILED" not in "".join(rows)


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_dryrun_refuses_the_production_meshes(tmp_path, mesh):
    with pytest.raises(SystemExit, match="one card"):
        dryrun.main(["--mesh", mesh, "--out", str(tmp_path)])


if __name__ == "__main__":
    _reference_child(sys.argv[1])
