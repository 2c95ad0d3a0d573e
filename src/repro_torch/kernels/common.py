"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (device code that
several sources share sits in ``csrc/*.cuh``).  On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root and loaded with `ctypes`; nothing
includes PyTorch's headers, so a build takes seconds.  The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Builds happen only when a
kernel is first launched, never at import: the CPU tests import every
module on machines without ``nvcc``.

C entries take pointers and the stream as ``ctypes.c_void_p`` (a plain
``int`` argument would be cut to 32 bits) and return ``cudaGetLastError()``;
a launch raises on anything but 0, since a refused launch never runs and a
later synchronise does not report it.

Every ``ops`` module binds its C entries through `Entry`: the symbol is
looked up and its ``argtypes`` / ``restype`` set once, on the first launch,
and kept in the module-level object; later launches take no lock and build
no Python objects beyond ctypes' own conversion.  `current_stream(device)`
gives the current stream's raw handle by PyTorch's cheapest call
(``torch._C._cuda_getCurrentRawStream``, which builds no ``Stream``
object); a CUDA build of PyTorch without it is refused at import, and a
build without CUDA raises at the first launch.  `ENTRIES` lists every
entry, so a test can hold each one's ``argtypes`` to its ``extern "C"``
declaration.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc's stderr per kernel (ptxas register / shared-memory / spill report)
BUILD_LOG: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (put the CUDA toolkit's bin on PATH)")


def library_path(name: str) -> Path:
    """Where `name`'s library goes: keyed by a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG[name] = proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {name} (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: a concurrent build never sees half a file
    return out


def _no_cuda(device: int) -> int:
    raise RuntimeError(f"PyTorch {torch.__version__} has no CUDA: a kernel cannot be "
                       f"launched on device {device}")


if torch.version.cuda is None:
    current_stream = _no_cuda
else:
    current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if current_stream is None:
        raise ImportError(f"PyTorch {torch.__version__} (CUDA {torch.version.cuda}) has no "
                          "torch._C._cuda_getCurrentRawStream, the kernels' stream lookup")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


ENTRIES: dict[str, "Entry"] = {}    # C symbol -> its binding, over every ops module


class Entry:
    """One C entry of ``csrc/<source>.cu``: `argtypes` are its arguments
    before the stream, which every entry takes last.  Calling it launches
    (the library is built and the symbol bound on the first call) and
    raises if the launch was refused."""

    __slots__ = ("source", "symbol", "argtypes", "fn")

    def __init__(self, source: str, symbol: str, argtypes) -> None:
        if symbol in ENTRIES:
            raise ValueError(f"C entry {symbol} is bound twice")
        self.source, self.symbol = source, symbol
        self.argtypes = (*argtypes, ctypes.c_void_p)
        self.fn = None
        ENTRIES[symbol] = self

    def bind(self):
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        self.fn = fn
        return fn

    def __call__(self, *args) -> None:
        """Launch with `args`, the stream's raw handle last."""
        rc = (self.fn or self.bind())(*args)
        if rc:
            raise RuntimeError(f"CUDA launch of {self.source}.{self.symbol} failed: "
                               f"cudaError {rc}")
