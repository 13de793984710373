"""ctypes binding of the native BVH builder (counterpart of
``raytracercore_tpu.native.lib``).

``csrc/bvh_builder.cpp`` is host C++ (no CUDA): it is compiled with the
host C++ compiler at first use into the package's ``build/`` directory,
which git ignores, under a name that carries a hash of the source, and
loaded with ``ctypes``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..kernels import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "bvh_builder.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_loaded: dict = {}


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libbvh_{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found (c++, g++ or clang++) to "
                       "build the native BVH builder")


def load() -> ctypes.CDLL:
    """The builder library, compiled on first use.  Raises ``RuntimeError``
    when there is no compiler or the build fails."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is not None:
            return lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"native BVH builder: build failed (exit "
                    f"{proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.rtc_build_bvh.restype = ctypes.c_int
        lib.rtc_build_bvh.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                      fp, fp, ip, ip, ip, ip, ip]
        _loaded["lib"] = lib
        return lib


def build_bvh_native(box_min: np.ndarray, box_max: np.ndarray,
                     leaf_size: int):
    """Run the C++ binned-SAH builder over ``[T, 3]`` float32 per-row
    bounds.  Returns ``(bmin [N, 3], bmax [N, 3], skip [N], leaf_slot [N],
    leaf_prims [L, K])`` as numpy arrays, leaf entries indexing the given
    rows."""
    lib = load()
    n = int(box_min.shape[0])
    bmin = np.ascontiguousarray(box_min, np.float32)
    bmax = np.ascontiguousarray(box_max, np.float32)
    cap_nodes = 2 * n + 1
    out_bmin = np.empty((cap_nodes, 3), np.float32)
    out_bmax = np.empty((cap_nodes, 3), np.float32)
    out_skip = np.empty(cap_nodes, np.int32)
    out_slot = np.empty(cap_nodes, np.int32)
    out_prims = np.empty(cap_nodes * leaf_size, np.int32)
    n_nodes = np.zeros(1, np.int32)
    n_leaves = np.zeros(1, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.rtc_build_bvh(fp(bmin), fp(bmax), n, leaf_size, fp(out_bmin),
                           fp(out_bmax), ip(out_skip), ip(out_slot),
                           ip(out_prims), ip(n_nodes), ip(n_leaves))
    if rc != 0:
        raise RuntimeError(f"native BVH builder returned {rc}")
    nn, nl = int(n_nodes[0]), int(n_leaves[0])
    return (out_bmin[:nn].copy(), out_bmax[:nn].copy(), out_skip[:nn].copy(),
            out_slot[:nn].copy(),
            out_prims[: nl * leaf_size].reshape(nl, leaf_size).copy())
