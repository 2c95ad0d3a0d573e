"""The peer all-to-all on the card: every block stored by kernel row 4's peer
form (`kernels.rma.ops.all_to_all`, p launches of ``rma_peer_put`` a call)
against `ProcMesh.all_to_all` (the mesh's ``copy_`` a block), over 3
processes sharing the card, for each payload dtype of the DSDE, MoE,
hashtable and FFT paths.  Also the plan's route under "auto": an
all-to-all group of whole-word CUDA blocks takes "cuda" and launches the
kernel p times, a 3-byte block takes "torch" and launches nothing.

Needs an NVIDIA card and ``nvcc``: skipped here otherwise.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import procmesh  # noqa: E402

NPROC = 3
TIMEOUT = 240.0
# dtype -> block a destination (bytes a multiple of 4, one not contiguous)
BLOCKS = {"float32": (torch.float32, (5, 3)), "int32": (torch.int32, (7,)),
          "bool": (torch.bool, (2048,)), "bfloat16": (torch.bfloat16, (6, 2048)),
          "int64": (torch.int64, (9, 3)), "complex64": (torch.complex64, (4, 8, 8)),
          "strided": (torch.float32, (4, 6))}


def _payload(torch, name: str, rank: int, p: int, dev):
    dtype, block = BLOCKS[name]
    g = torch.Generator(device=dev).manual_seed(31 + rank)
    raw = torch.randint(0, 256, (1, p) + block + (dtype.itemsize,), dtype=torch.uint8,
                        device=dev, generator=g)
    if dtype == torch.bool:
        x = (raw[..., 0] & 1).bool()
    else:
        x = raw.view(dtype)[..., 0]
    if name == "strided":
        x = x.transpose(2, 3)            # a block that is not contiguous
    return x


def _card_rank(mesh) -> dict:
    from repro_torch.core import plan as tplan
    from repro_torch.kernels.rma import ops as rma_ops

    out = {}
    for name in BLOCKS:
        x = _payload(torch, name, mesh.rank, mesh.p, mesh.device)
        want = mesh.all_to_all(x)
        before = rma_ops.launches["put_shift"]
        got = rma_ops.all_to_all(x, mesh)
        torch.cuda.synchronize()
        launched = rma_ops.launches["put_shift"] - before
        pl = tplan.RmaPlan(mesh)
        h = pl.put_all_to_all(x)
        held = mesh.barriers
        stats = pl.flush()
        same = torch.equal(got.view(torch.uint8), want.view(torch.uint8)) \
            and torch.equal(h.result().view(torch.uint8), want.view(torch.uint8))
        out[name] = {"same": bool(same), "launched": launched, "backends": stats.backends,
                     "fences": mesh.barriers - held}
    x = torch.ones(1, mesh.p, 3, dtype=torch.uint8, device=mesh.device)
    before = rma_ops.launches["put_shift"]
    pl = tplan.RmaPlan(mesh)
    h = pl.put_all_to_all(x)
    out["uint8x3"] = {"backends": pl.flush().backends,
                      "launched": rma_ops.launches["put_shift"] - before,
                      "same": bool(torch.equal(h.result(), mesh.all_to_all(x)))}
    return out


@pytest.mark.cuda
def test_the_peer_all_to_all_equals_the_meshs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    for res in procmesh.run(_card_rank, NPROC, timeout=TIMEOUT):
        for name in BLOCKS:
            r = res[name]
            assert r["same"], name
            assert r["launched"] == NPROC, (name, r)            # one launch a block
            assert r["backends"] == {"cuda": 1} and r["fences"] == 1, (name, r)
        r = res["uint8x3"]
        assert r["same"] and r["backends"] == {"torch": 1} and r["launched"] == 0
