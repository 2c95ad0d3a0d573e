"""The split page walk of the paged-attention kernel, on the CPU.

Pure PyTorch, no JAX: the kernel's cut (`ops.plan`) and a plain model of
what the kernel computes with it — each row's page ids cut into splits, a
partial softmax state (m, l, acc) a split, the partials merged in split
order — held to the port's oracle `ref.paged_attention_ref` (itself held
to the reference's Pallas kernel by `test_torch_paged_attention.py`)
within 1e-6 abs.  The model runs in f64, so what the bound leaves room for
is the oracle's own f32 rounding (up to ~5e-7 at outputs of 2-4).  The CUDA kernel runs
only on a card (`test_torch_paged_attention_cuda.py`).
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

from .helpers import given, settings, st  # noqa: E402

TOL = 1e-6
# the decode path's cut sums 2048 keys a row: there the oracle's own f32
# rounding reaches ~1.1e-6 against the f64 model (unit scale, hd 8)
TOL_LONG = 2e-6
CU = pathlib.Path(common.CSRC) / "paged_attention.cu"


def split_merge(q, kv, ids, pages, scale=None, causal=False, read=None):
    """The kernel's arithmetic in plain torch: row (i, s)'s entries cut into
    splits of `pages` consecutive entries; a split lists its visible pages
    (a masked page, or one past the causal horizon, is skipped and, past
    the horizon, its id is not read), records (m_j, l_j, acc_j) over their
    tokens or l_j = 0, and the splits merge in order:
    out = sum e^(m_j - M) acc_j / max(sum e^(m_j - M) l_j, 1e-30).
    `read`, if given, collects the (i, s, entry) whose id was read."""
    m, Sq, hd = q.shape
    n_pages, pt = kv.shape[0], kv.shape[1]
    k = ids.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    qs = q * scale
    out = torch.zeros_like(qs)
    splits = -(-k // pages)
    for i in range(m):
        for s in range(Sq):
            horizon = s + k * pt - Sq
            parts = []
            for j in range(splits):
                keys, vals = [], []
                for e in range(j * pages, min(k, (j + 1) * pages)):
                    n_vis = min(pt, horizon - e * pt + 1) if causal else pt
                    if n_vis <= 0:
                        continue
                    if read is not None:
                        read.add((i, s, e))
                    pid = int(ids[i, e])
                    if pid < 0:
                        continue
                    pid = min(pid, n_pages - 1)
                    keys.append(kv[pid, :n_vis, 0])
                    vals.append(kv[pid, :n_vis, 1])
                if not keys:
                    parts.append(None)                  # l = 0: nothing visible
                    continue
                sc = torch.cat(keys) @ qs[i, s]
                m_j = sc.max()
                p = torch.exp(sc - m_j)
                parts.append((m_j, p.sum(), p @ torch.cat(vals)))
            live = [t for t in parts if t is not None]
            if not live:
                continue                                # a fully masked row: 0
            M = torch.stack([t[0] for t in live]).max()
            num = torch.zeros(hd, dtype=qs.dtype)
            den = torch.zeros((), dtype=qs.dtype)
            for m_j, l_j, acc_j in live:                # split order
                w = torch.exp(m_j - M)
                num = num + w * acc_j
                den = den + w * l_j
            out[i, s] = num / torch.clamp(den, min=1e-30)
    return out


def _err(q, kv, ids, pages, scale=None, causal=False, read=None) -> tuple:
    """The f64 model and its max abs distance from the f32 oracle."""
    got = split_merge(q.double(), kv.double(), ids, pages, scale=scale, causal=causal,
                      read=read)
    want = ref.paged_attention_ref(q, kv, ids, scale=scale, causal=causal)
    return got, float((got - want.double()).abs().max())


def _inputs(m, Sq, hd, pt, k, n_pages, seed, mask=0.2):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((m, Sq, hd)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((n_pages, pt, 2, hd)).astype(np.float32))
    ids = rng.integers(0, n_pages + 3, (m, k)).astype(np.int32)   # some past the pool
    ids[rng.random((m, k)) < mask] = -1
    return q, kv, ids


# ---- the plan

PLAN_GRID = [
    (64, 1, 128, 16, 128),      # the fused decode step
    (4, 1, 128, 16, 128),       # the rendezvous pull's shift form
    (3, 4, 9, 16, 128), (3, 1, 9, 4, 32), (1, 1, 1, 1, 1024), (64, 8, 128, 16, 128),
    (1, 1, 5000, 16, 128), (2000, 1, 128, 16, 128), (3, 8, 130, 4, 128),
    (2, 1, 128, 64, 128), (2, 4, 128, 16, 1024), (5, 3, 77, 2, 96), (0, 1, 8, 16, 128),
]


@pytest.mark.parametrize("m,Sq,k,pt,hd", PLAN_GRID)
def test_plan_covers_every_entry_once(m, Sq, k, pt, hd):
    pl = ops.plan(m, Sq, k, pt, hd)
    assert 1 <= pl.pages <= ops.MAX_PAGES and 1 <= pl.group <= ops.MAX_GROUP
    cover = [e for j in range(pl.splits)
             for e in range(j * pl.pages, min(k, (j + 1) * pl.pages))]
    assert cover == list(range(k))                         # each entry once, in order
    assert all(j * pl.pages < k for j in range(pl.splits))  # no empty split
    rows = m * Sq
    assert rows == 0 or pl.group == -(-rows // pl.groups)
    assert pl.blocks == pl.groups * pl.splits
    assert pl.group <= 1 or pl.groups % 2 == 1
    # block group g serves rows g + j * groups, j < group: every row once
    served = [g + j * pl.groups for g in range(pl.groups) for j in range(pl.group)
              if g + j * pl.groups < rows]
    assert sorted(served) == list(range(rows))
    # the C side: (m, l) of every (row, split), padded to 4 floats so that
    # acc[hd] of each starts on 16 bytes
    ml = 2 * rows * pl.splits
    assert pl.workspace == (ml + 3) // 4 * 4 + rows * pl.splits * hd
    # a split walks at most SPLIT_BYTES of pages, unless one page is more
    assert pl.pages == 1 or pl.pages * pt * 2 * hd * 4 <= ops.SPLIT_BYTES


def test_plan_spreads_the_main_path():
    """One valid row of the decode path (k = 128 pages of 16 tokens, hd
    128) spreads over at least 32 blocks, in both entries' shapes; the grid
    stays within the block budget but for the group that makes the count
    odd; and rows that are a power of two apart (the fused step's rows are
    rank * 16 + slot) never share a block."""
    for m in (64, 4):
        pl = ops.plan(m, 1, 128, 16, 128)
        assert pl.splits >= 32
        assert pl.blocks <= ops.BLOCK_BUDGET + pl.splits
        for r in range(m):
            for d in (1, 2, 4, 8, 16, 32):
                assert r + d >= m or r % pl.groups != (r + d) % pl.groups


def test_plan_constants_match_the_kernel():
    src = CU.read_text()
    for name, value in (("kMaxPages", ops.MAX_PAGES), ("kMaxGroup", ops.MAX_GROUP)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    # the C entry refuses any plan whose splits do not cover k, puts the
    # accumulators where the plan's workspace has them and gives a block
    # the rows the plan says
    assert "a.S != (a.k + a.P - 1) / a.P" in src
    assert "a.ws + ((size_t)2 * a.rows * a.S + 3) / 4 * 4" in src
    assert "a.G = (a.rows + a.groups - 1) / a.groups;" in src


@pytest.mark.parametrize("bad", [(1, 1, 0, 16, 128), (1, 1, 8, 0, 128), (-1, 1, 8, 16, 128)])
def test_plan_refuses_empty_shapes(bad):
    with pytest.raises(ValueError):
        ops.plan(*bad)


# ---- split-then-merge against the oracle

@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), pages=st.integers(1, 8), Sq=st.integers(1, 6),
       k=st.integers(1, 14), pt=st.sampled_from([1, 2, 4, 8]),
       causal=st.sampled_from([False, True]), mask=st.floats(0.0, 1.0))
def test_split_merge_matches_oracle(seed, pages, Sq, k, pt, causal, mask):
    """Drawn masks, split sizes, Sq and causal horizons; row 0 has one
    fully masked split, row 2 is fully masked."""
    q, kv, ids = _inputs(3, Sq, 8, pt, k, 10, seed, mask)
    j = seed % (-(-k // pages))
    ids[0, j * pages:(j + 1) * pages] = -1
    ids[2] = -1
    ids = torch.from_numpy(ids)
    read = set()
    got, err = _err(q, kv, ids, pages, causal=causal, read=read)
    assert err <= TOL
    assert float(got[2].abs().max()) == 0.0
    # no id past the causal horizon is read
    for _, s, e in read:
        assert not causal or e * pt <= s + k * pt - Sq


@pytest.mark.parametrize("pages", [1, 3, 4, 10])
def test_split_merge_horizon_inside_a_split(pages):
    """Sq 12 over 10 pages of 2 tokens: position 0 sees 9 tokens, so its
    horizon falls inside page 4 and whole splits lie past it."""
    q, kv, ids = _inputs(2, 12, 16, 2, 10, 12, seed=pages, mask=0.0)
    ids = torch.from_numpy(ids)
    read = set()
    _, err = _err(q, kv, ids, pages, causal=True, read=read)
    assert err <= TOL
    assert (0, 11, 9) in read                   # position 11 sees the last page
    assert max(e for _, s, e in read if s == 0) == 4


@pytest.mark.parametrize("causal", [False, True])
def test_split_merge_at_the_main_path_cut(causal):
    """The plan of the decode path's shapes (4 pages a split, 32 splits)
    on a narrow pool: 2 valid rows of 64, one of them with two masked
    splits, the rest fully masked."""
    pl = ops.plan(64, 1, 128, 16, 128)
    q, kv, ids = _inputs(64, 1, 8, 16, 128, 300, seed=3, mask=0.1)
    ids[:] = np.where(np.isin(np.arange(64), (33, 50))[:, None], ids, -1)
    ids[33, 8:16] = -1
    ids = torch.from_numpy(ids)
    got, err = _err(q, kv, ids, pl.pages, scale=1.0, causal=causal)
    assert err <= TOL_LONG
    assert float(got[[i for i in range(64) if i not in (33, 50)]].abs().max()) == 0.0


def test_split_merge_every_page_masked():
    q, kv, ids = _inputs(3, 4, 8, 4, 9, 12, seed=1)
    ids = torch.full_like(torch.from_numpy(ids), -1)
    got = split_merge(q, kv, ids, 2, causal=True)
    assert float(got.abs().max()) == 0.0
    assert torch.equal(got, ref.paged_attention_ref(q, kv, ids, causal=True))


# ---- the CPU path

def test_cpu_path_is_the_oracle_and_counts_no_launch(monkeypatch):
    """On CPU tensors both entries compute `ref` and touch neither the plan,
    the build nor the launch counts."""
    from repro_torch.mesh import Mesh

    def refuse(*a, **kw):
        raise AssertionError("the CPU path reached the kernel's side")

    monkeypatch.setattr(ops, "plan", refuse)
    monkeypatch.setattr(common, "load", refuse)
    before = (ops.launches, ops.shift_launches)
    q, kv, ids = _inputs(3, 4, 32, 4, 9, 12, seed=2)
    ids = torch.from_numpy(ids)
    out = ops.paged_attention(q, kv, ids, causal=True)
    assert torch.equal(out, ref.paged_attention_ref(q, kv, ids, causal=True))
    pools = torch.stack([kv, kv.flip(0), kv * 0.5, kv + 1.0])
    qp = q[:3].repeat(2, 1, 1)[:4]
    idp = torch.cat([ids, ids[:1]])
    mesh = Mesh(4, "x", device="cpu")
    out = ops.paged_attention_shift(qp, pools, idp, 1, mesh)
    assert torch.equal(out, ref.paged_attention_shift_ref(qp, pools, idp, 1, mesh))
    assert (ops.launches, ops.shift_launches) == before
