"""Atomic, asynchronous checkpoints in the reference's on-disk format (the
counterpart of `repro.ckpt.checkpoint`), so a checkpoint written by either
package restores in the other.

  * atomic: written to ``<dir>/tmp.<step>.<pid>``, the manifest fsynced, then
    renamed to ``step_<8 digits>``; a crash mid-save never leaves a torn
    ``step_`` directory.  The newest `keep` (3) survive.
  * asynchronous: the device-to-host copy runs on the caller's thread;
    compression and the write run on a background thread, and the next
    `save` (or `wait`) joins it.
  * the format: ``manifest.json`` ({"step", "extra", "codec", "arrays":
    [{"key", "shape", "dtype"}]}) and ``data.msgpack.zst``, one msgpack
    ``bin`` object a leaf in manifest order, compressed with zstd when
    `zstandard` is installed and with zlib (level 6) otherwise; the manifest
    names the codec, and a zstd checkpoint is refused where `zstandard` is
    missing.  Keys are the leaves' paths as the reference's `_flatten`
    renders them: dict keys, tuple indices, and a NamedTuple's fields as
    ``.name`` (``0/tok/embed``, ``1/.step``, ``1/.mu/tok/embed``); dtypes
    are numpy's names, ``bfloat16`` for bf16.

The ``bin`` 8/16/32 framing is written and read here (no `msgpack`), and a
bf16 leaf goes through its 16-bit pattern (no `ml_dtypes`).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

try:  # optional, as in the reference
    import zstandard
except ImportError:  # pragma: no cover - exercised where zstd is absent
    zstandard = None

DEFAULT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"
_DATA, _MANIFEST = "data.msgpack.zst", "manifest.json"
_CHUNK = 1 << 20


# ------------------------------------------------------------------ codecs
class _ZlibWriter:
    def __init__(self, f, level: int = 6):
        self._f, self._c = f, zlib.compressobj(level)

    def write(self, data) -> int:
        self._f.write(self._c.compress(data))
        return len(data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.write(self._c.flush())
        return False


class _ZlibReader:
    def __init__(self, f):
        self._f, self._d, self._buf = f, zlib.decompressobj(), b""

    def read(self, n: int) -> bytes:
        parts, have = [self._buf], len(self._buf)
        while have < n and not self._d.eof:     # one join a read, not one a chunk
            raw = self._f.read(_CHUNK)
            parts.append(self._d.decompress(raw) if raw else self._d.flush())
            have += len(parts[-1])
            if not raw:
                break
        data = b"".join(parts)
        out, self._buf = data[:n], data[n:]
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def codec_name() -> str:
    return "zstd" if zstandard is not None else "zlib"


def _need_zstd(codec: str) -> None:
    if codec == "zstd" and zstandard is None:
        raise RuntimeError("checkpoint written with zstd but zstandard not installed")


def _writer(f, codec: str):
    _need_zstd(codec)
    return zstandard.ZstdCompressor(level=3).stream_writer(f) if codec == "zstd" \
        else _ZlibWriter(f)


def _reader(f, codec: str):
    _need_zstd(codec)
    return zstandard.ZstdDecompressor().stream_reader(f) if codec == "zstd" \
        else _ZlibReader(f)


# ------------------------------------------------------ msgpack bin framing
def pack_bin(data: bytes) -> bytes:
    """msgpack's ``bin 8 / 16 / 32`` object holding `data`."""
    n = len(data)
    if n < 1 << 8:
        head = b"\xc4" + n.to_bytes(1, "big")
    elif n < 1 << 16:
        head = b"\xc5" + n.to_bytes(2, "big")
    elif n < 1 << 32:
        head = b"\xc6" + n.to_bytes(4, "big")
    else:
        raise ValueError(f"a msgpack bin holds < 2**32 bytes, got {n}")
    return head + data


def _read_exact(r, n: int) -> bytes:
    parts, got = [], 0
    while got < n:
        b = r.read(n - got)
        if not b:
            raise ValueError(f"checkpoint data ends {n - got} bytes early")
        parts.append(b)
        got += len(b)
    return b"".join(parts)


def unpack_bin(r) -> bytes:
    code = _read_exact(r, 1)[0]
    width = {0xC4: 1, 0xC5: 2, 0xC6: 4}.get(code)
    if width is None:
        raise ValueError(f"expected a msgpack bin object, got type byte {code:#x}")
    return _read_exact(r, int.from_bytes(_read_exact(r, width), "big"))


# ------------------------------------------------------------- leaves
def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) in the reference's order: dict keys sorted, tuple items
    by index, NamedTuple fields in order as ``.name``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten_like(like: Any, values: dict, prefix: str = "") -> Any:
    def key(k):
        return f"{prefix}/{k}" if prefix else k

    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, key(str(k))) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(getattr(like, f), values, key(f".{f}"))
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_like(v, values, key(str(i))) for i, v in enumerate(like))
    return values[prefix]


def _to_host(t: torch.Tensor) -> tuple[str, list, bytes]:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return "bfloat16", list(t.shape), t.view(torch.int16).numpy().tobytes()
    arr = t.numpy()
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _from_host(raw: bytes, dtype: str, shape: list) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype)).copy()).reshape(shape)


# ------------------------------------------------------------- manager
class CheckpointManager:
    def __init__(self, directory=DEFAULT_DIR, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Copy to host memory now; compress and write in the background."""
        self.wait()
        host = [(key, *_to_host(leaf)) for key, leaf in flatten(tree)]

        def write():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}") from err

    def _write(self, step: int, host: list, extra: dict) -> None:
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        codec = codec_name()
        manifest = {"step": step, "extra": extra, "codec": codec, "arrays": []}
        with open(os.path.join(tmp, _DATA), "wb") as f:
            with _writer(f, codec) as zf:
                for key, dtype, shape, raw in host:
                    manifest["arrays"].append({"key": key, "shape": shape, "dtype": dtype})
                    zf.write(pack_bin(raw))
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            path = os.path.join(self.directory, f"step_{s:08d}")
            for root, dirs, files in os.walk(path, topdown=False):
                for fn in files:
                    os.unlink(os.path.join(root, fn))
                for d in dirs:
                    os.rmdir(os.path.join(root, d))
            os.rmdir(path)

    # ---------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.directory)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> tuple[Any, dict]:
        """Restore into the structure of `like`, each leaf in that leaf's
        dtype and on its device; returns (tree, extra).

        `shardings` (a tree like `like`'s, of `parallel.sharding`
        placements, e.g. a policy's `tree_shardings`) may target another
        mesh than the one that saved: the elastic re-shard path.  Each leaf
        with a placement is checked to tile its mesh exactly and goes to the
        mesh's device (`like` may then be meta tensors); the values are the
        checkpoint's either way.  Over a grid `ProcMesh` a placed leaf is
        only this rank's block of it (`NamedSharding.held`), a tensor of its
        own; the files are the same."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        arrays: dict[str, torch.Tensor] = {}
        with open(os.path.join(path, _DATA), "rb") as f:
            with _reader(f, manifest.get("codec", "zstd")) as zf:
                for meta in manifest["arrays"]:
                    arrays[meta["key"]] = _from_host(unpack_bin(zf), meta["dtype"],
                                                     meta["shape"])
        placed = {} if shardings is None else dict(
            (key, sh) for key, sh in flatten(shardings) if sh is not None)
        values = {}
        for key, leaf in flatten(like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            device, value = leaf.device, arrays[key]
            if key in placed:
                placed[key].check(value.shape)
                device, value = placed[key].mesh.device, placed[key].held(value)
            values[key] = torch.empty(value.shape, dtype=leaf.dtype,
                                      device=device).copy_(value)
        return _unflatten_like(like, values), manifest["extra"]
