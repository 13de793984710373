"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, at first use, and loaded
with ``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.  The
build goes to ``build/`` inside the package, which git ignores.

Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# fp32 as written: no fused multiply-add contraction and no fast math, so
# the kernel-vs-plain comparison measures the algorithm.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the library's entry points.
SIGNATURES = {
    "rtc_trace_fused": (
        [_P] * 18                      # 11 inputs, 7 outputs
        + [_I] * 7                     # R T S P N n_bounces recursion
        + [_F, _F]                     # eps_behind, eps_pos²
        + [_I] * 4                     # ambient_is_miss want_tape
                                       # any_smooth coplanar
        + [_P]),                       # stream
}

_loaded: dict = {}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def library_path() -> Path:
    return BUILD_DIR / f"librtc_kernels_{source_hash()}.so"


def build() -> dict:
    """Compile ``csrc/*.cu`` into the shared library unless it is already
    built.  Returns ``{"path", "seconds", "built", "log"}``: ``log`` is
    nvcc's output (``-Xptxas -v`` register and spill counts)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "built": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True, "log": log}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    ``argtypes``/``restype`` declared.  Loaded once per process: later
    calls return it without looking at the sources again."""
    lib = _loaded.get("lib")
    if lib is None:
        path = build()["path"]
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return lib
