"""Build and bind the port's CUDA sources with ``nvcc`` and ``ctypes``.

Each source in ``repro_torch/csrc`` compiles, at first use, into a shared
library with a plain C interface under
``build/repro_torch_kernels/<hash of the source>/`` at the checkout root (a
directory ``.gitignore`` lists), for ``sm_90a``.  Nothing here runs at
import time: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
# argument types of every C entry, by library then symbol
_SIGNATURES = {
    "bitmap_popcount": {
        "peel_wave_launch": (_P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                             ctypes.c_int, _P, _P, _P, _P, _P),
        "bitmap_support_launch": (_P, _P, ctypes.c_longlong, _P, _P,
                                  ctypes.c_int, ctypes.c_int, _P, _P),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; the
    compiler's report (``-Xptxas -v``) is kept beside it as ``build.log``."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str = "bitmap_popcount") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    ``argtypes``/``restype`` declared for every entry."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for sym, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
