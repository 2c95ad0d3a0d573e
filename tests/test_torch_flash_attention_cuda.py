"""The flash-attention CUDA kernel against its plain PyTorch version on the
card, at the shapes `chip_smoke.py`'s model phases give it and at edge
cases: bf16 within 2e-2 (one bf16 ulp at outputs of magnitude 2-4), f32
within 1e-4 (the order of the sums differs).  Both variants are held: the
"wgmma" one (bf16 at hd 64 and 128) and the "simt" one (the rest), and
`ops.launches_by_variant` must show which ran.  These tests carry the
`cuda` marker and skip where no card is present; the file imports no JAX,
so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# (B, Hq, Hkv, Sq, Sk, hd, causal, dtype)
CASES = [
    (4, 15, 5, 2048, 2048, 64, True, torch.bfloat16),     # SmolLM-360M's forward
    (1, 32, 2, 4096, 4096, 128, True, torch.bfloat16),    # chatglm3-6b's heads
    (2, 4, 2, 40, 300, 64, True, torch.float32),          # Sq < Sk
    (1, 6, 3, 1, 77, 128, True, torch.float32),           # one row at the end
    (3, 4, 4, 1000, 1000, 64, False, torch.float32),      # non-causal, g = 1, B = 3
    (1, 8, 2, 130, 130, 128, True, torch.float32),        # ragged last tile
    (2, 4, 1, 200, 200, 64, True, torch.bfloat16),        # MQA
    # the SMOKE configs' head dims (16, 20) and the reference test's 32:
    # zero-padded to the 16 / 32 instances
    (2, 4, 2, 37, 37, 16, True, torch.bfloat16),
    (2, 4, 2, 37, 37, 16, True, torch.float32),
    (1, 4, 2, 130, 130, 20, True, torch.bfloat16),
    (1, 4, 2, 130, 130, 20, True, torch.float32),
    (2, 4, 4, 70, 100, 32, True, torch.bfloat16),
    (2, 4, 4, 70, 100, 32, False, torch.float32),
    (1, 2, 1, 65, 65, 96, True, torch.float32),           # padded to 128
]
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# the "wgmma" variant, bf16: (B, Hq, Hkv, Sq, Sk, hd, causal)
WGMMA_CASES = [
    (2, 4, 4, 64, 64, 64, True),          # g = 1, one tile
    (1, 6, 2, 130, 130, 128, True),       # g = 3, ragged tiles
    (2, 8, 2, 1000, 1000, 64, True),      # g = 4
    (1, 16, 1, 2047, 2047, 128, True),    # g = 16 (MQA), one key short of 16 tiles
    (2, 4, 1, 2047, 2047, 64, True),
    (2, 32, 8, 2048, 2048, 128, True),    # Jamba's attention layer
    (3, 4, 4, 1000, 1000, 128, False),    # non-causal, B = 3
    (1, 4, 4, 64, 130, 64, False),        # non-causal, ragged keys
    (2, 6, 2, 100, 700, 64, True),        # Sq < Sk
    (2, 6, 2, 130, 300, 128, True),
    (1, 8, 2, 1, 300, 128, True),         # one row at the end
    (1, 4, 2, 300, 200, 64, True),        # Sq > Sk: the first 100 rows see no key
    (1, 4, 2, 300, 200, 128, True),
]

# causal, Sk - Sq not a multiple of 128: a block's first warpgroup sees fewer
# key tiles than its second (or none), and blocks take several query tiles
# (work items) in turn
SKIP_CASES = [
    (4, 16, 4, 1000, 1064, 64),     # the first warpgroup skips the last tile
    (4, 32, 8, 2048, 1000, 64),     # many rows see no key
    (2, 32, 8, 700, 600, 128),
    (3, 12, 4, 1500, 1600, 128),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _qkv(B, Hq, Hkv, Sq, Sk, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, Hq, Sq, hd, generator=g, device="cuda").to(dtype),
            torch.randn(B, Hkv, Sk, hd, generator=g, device="cuda").to(dtype),
            torch.randn(B, Hkv, Sk, hd, generator=g, device="cuda").to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd,causal,dtype", CASES)
def test_kernel_matches_plain(card, B, Hq, Hkv, Sq, Sk, hd, causal, dtype):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, hd, dtype, seed=Sq + hd)
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal)
    assert torch.isfinite(out).all()
    err = float((out.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd,causal", WGMMA_CASES)
def test_wgmma_variant_matches_plain(card, B, Hq, Hkv, Sq, Sk, hd, causal):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, hd, torch.bfloat16, seed=Sq + Sk + hd)
    before = dict(ops.launches_by_variant)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches_by_variant == {"wgmma": before["wgmma"] + 1, "simt": before["simt"]}
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out).all()
    want = ref.attention_ref(q, k, v, causal=causal)
    err = float((out.float() - want.float()).abs().max())
    assert err <= TOL[torch.bfloat16], err
    if causal and Sq > Sk:
        assert not out[:, :, :Sq - Sk].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd", SKIP_CASES)
def test_wgmma_variant_where_a_warpgroup_sees_fewer_tiles(card, B, Hq, Hkv, Sq, Sk, hd):
    """Repeated launches agree bit for bit and with the plain version where
    one warpgroup of a block walks tiles it cannot see (all -inf there):
    the stage and Q releases stay in step across work items."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, hd, torch.bfloat16, seed=Sq + Sk)
    want = ref.attention_ref(q, k, v, causal=True)
    first = ops.flash_attention(q, k, v, causal=True)
    for _ in range(4):
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert float((first.float() - want.float()).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_launches_by_variant_shows_which_ran(card):
    """bf16 at hd 64 and 128 runs "wgmma"; f32, and bf16 at other head
    dims, run "simt"; `launches` counts both."""
    runs = [(torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
            (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
            (torch.bfloat16, 32, "simt"), (torch.bfloat16, 96, "simt")]
    for dtype, hd, kind in runs:
        q, k, v = _qkv(1, 4, 2, 70, 70, hd, dtype, seed=hd)
        before, total = dict(ops.launches_by_variant), ops.launches
        ops.flash_attention(q, k, v)
        want = dict(before, **{kind: before[kind] + 1})
        assert ops.launches_by_variant == want and ops.launches == total + 1, (dtype, hd)


@pytest.mark.cuda
def test_wgmma_variant_raises_on_a_misaligned_view(card):
    """A view whose base or row stride breaks the TMA's 16-byte rule raises
    ValueError; it never gives way to the other variant."""
    g = torch.Generator(device="cuda").manual_seed(4)
    big = torch.randn(1, 4, 64, 72, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(1, 2, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    before = dict(ops.launches_by_variant)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(big[..., 1:65], k, k)        # base 2 bytes past the storage's
    odd = torch.randn(1, 2, 64, 68, generator=g, device="cuda").to(torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ops.flash_attention(big[..., :64], odd, odd)     # rows 136 bytes apart
    assert ops.launches_by_variant == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.float32, 64)])
def test_no_keys_give_zeros(card, dtype, hd):
    """Sk = 0: both variants write zeros (no tile is loaded)."""
    q, k, v = _qkv(2, 4, 2, 70, 0, hd, dtype, seed=11)
    for causal in (True, False):
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert out.shape == q.shape and not out.any()


@pytest.mark.cuda
def test_rows_that_see_no_key_are_zero(card):
    q, k, v = _qkv(1, 4, 2, 90, 60, 64, torch.float32, seed=5)
    out = ops.flash_attention(q, k, v, causal=True)
    assert not out[:, :, :30].any()
    want = ref.attention_ref(q, k, v, causal=True)
    assert float((out - want).abs().max()) <= TOL[torch.float32]


@pytest.mark.cuda
def test_strided_views_as_the_model_passes_them(card):
    """The model hands over [B, S, H, hd] tensors transposed to [B, H, S, hd]."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(2, 300, 15, 64, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(2, 300, 5, 64, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(2, 300, 5, 64, generator=g, device="cuda").to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    before = ops.launches_by_variant["wgmma"]
    out = ops.flash_attention(qt, kt, vt)
    want = ops.flash_attention(qt.contiguous(), kt.contiguous(), vt.contiguous())
    assert ops.launches_by_variant["wgmma"] == before + 2
    assert torch.equal(out, want)
    assert float((out.float() - ref.attention_ref(qt, kt, vt).float()).abs().max()) <= 2e-2


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(card):
    k = torch.zeros(1, 2, 8, 192, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(torch.zeros(1, 4, 8, 192, device="cuda"), k, k)
    k16 = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ops.flash_attention(torch.zeros(1, 4, 8, 64, device="cuda", dtype=torch.float16),
                            k16, k16)


@pytest.mark.cuda
def test_backward_recomputes_through_the_plain_version(card):
    q, k, v = (t.requires_grad_(True) for t in _qkv(1, 4, 2, 70, 70, 64, torch.float32, 9))
    w = torch.randn_like(q)
    (ops.flash_attention(q, k, v) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (ref.attention_ref(q, k, v) * w).sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert torch.allclose(a, t.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_model_forward_launches_once_a_layer(card):
    """SmolLM-360M's widths at 2 layers: the cache-free forward under backend
    "cuda" launches the kernel once a layer and agrees with "torch"."""
    cfg = get_config("smollm-360m")
    import dataclasses

    cfg = dataclasses.replace(cfg, n_layers=2)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256), generator=g, device="cuda")}
    want = model.forward_logits(params, batch).logits
    before = ops.launches
    L.set_attention_backend("cuda")
    try:
        got = model.forward_logits(params, batch).logits
    finally:
        L.set_attention_backend("torch")
    assert ops.launches == before + cfg.n_layers
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert agree >= 0.95, agree
