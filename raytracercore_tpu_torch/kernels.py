"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, at first use, and loaded with
``ctypes``.  The library's file name carries a hash of the sources and
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
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32

# C signatures of the library's entry points.
SIGNATURES = {
    "rtc_trace_fused": (
        [_P] * 19                      # 11 inputs, 7 outputs, work
        + [_I] * 7                     # R T S P N n_bounces recursion
        + [_F, _F]                     # eps_behind, eps_pos²
        + [_I] * 4                     # ambient_is_miss want_tape
                                       # any_smooth coplanar
        + [_P]),                       # stream
    "rtc_uniforms": (
        [_P, _I, _I]                   # out, n, bounces
        + [_U, _U]                     # Philox key (lo, hi)
        + [_P]),                       # stream
    "rtc_replay_fwd": (
        [_P] * 11                      # 9 inputs, color, miss
        + [_I] * 5                     # R N n_bounces n_blocks
                                       # ambient_is_miss
        + [_P]),                       # stream
    "rtc_replay_bwd": (
        [_P] * 12                      # 9 inputs, color cotangent, partial,
                                       # work
        + [_I] * 8                     # R N n_bounces n_blocks
                                       # ambient_is_miss global_table regen
                                       # shared_stash
        + [_P]),                       # stream
    "rtc_replay_bwd_blocks_per_sm": (
        [_I] * 6                       # N n_bounces ambient_is_miss
                                       # global_table regen shared_stash
        + [_P]),                       # out [1]
    "rtc_issue_probe": (
        [_P, _P]                       # abc, out
        + [_I] * 3                     # n iters mix
        + [_P]),                       # stream
    "rtc_select": (
        [_P] * 21                      # 2 rays, 4 skip (null: none),
                                       # 4 tables, 9 outputs, work, keys
        + [_I] * 4                     # R T S P
        + [_F, _F]                     # eps_behind, eps_pos²
        + [_P]),                       # stream
    "rtc_traverse": (
        [_P] * 18                      # nodes, leaves, 2 rays, 4 skip (null:
                                       # none), order (null: identity),
                                       # 8 outputs, stats (null: none)
        + [_I] * 4                     # R n_nodes K leaf kind
        + [_F, _F]                     # eps_behind, eps_pos²
        + [_P]),                       # stream
    "rtc_sort_key": (
        [_P] * 5                       # 2 rays, root min and max, keys
        + [_I] * 3                     # R morton_bits dir_bits
        + [_P]),                       # stream
}

_loaded: dict = {}


def check_tensor(name, t, shape, dtype, device):
    """Raise ``ValueError`` unless tensor ``t`` has what a kernel reads
    through its raw pointer: the device, dtype and shape given, and a
    contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


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
    built: every source in its own ``nvcc`` process, all at once, then one
    link (about 7.8 s on an 8-core host, against 13.5 s for one ``nvcc``
    over all the sources, which compiles them one after another).  Returns ``{"path", "seconds", "built", "log"}``: ``log`` is
    nvcc's output (``-Xptxas -v`` register and spill counts)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "built": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(cu, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    steps = [(proc.args, proc.returncode, log)
             for proc, log in zip(procs, logs)]
    if all(rc == 0 for _, rc, _ in steps):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        steps.append((link, proc.returncode, proc.stdout + proc.stderr))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(text for _, _, text in steps)
    for cmd, rc, text in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text}")
    # Ranks that start together may each build: every file lands whole,
    # by rename, the log before the library that shows the build is done.
    tmp_log = BUILD_DIR / f"{tag}.tmp.log"
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
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
