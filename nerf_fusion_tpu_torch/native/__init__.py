"""The host kernel of LIF data generation (``sampler.cpp``), loaded with ctypes.

``sampler.cpp`` is compiled by ``g++`` at its first use into
``_build/libsampler-<digest>.so``; the digest covers the source, the
flags and the host's CPU (the flags hold ``-march=native``, so a library
built on another machine is not reused).  The flags are the JAX
package's, so both packages' samplers give the same bits.  There is no
fallback: a failed build raises (``ops.sdf_sampler.sign_vote_sdf_plain``
is the scipy version that the tests compare with).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall", "-shared")

_lib = None


def _host_tag() -> str:
    try:
        lines = [l for l in Path("/proc/cpuinfo").read_text().splitlines()
                 if l.startswith(("model name", "flags"))]
    except OSError:
        lines = []
    return "\n".join(sorted(set(lines))) + platform.machine()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _host_tag().encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsampler-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing; raises if ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.knn_sign_vote.argtypes = [dp, ctypes.c_int64, dp, dp, ctypes.c_int64,
                                      ctypes.c_int, dp, ctypes.POINTER(ctypes.c_uint8)]
        lib.knn_sign_vote.restype = None
        _lib = lib
    return _lib


def knn_sign_vote(queries: np.ndarray, surf_pts: np.ndarray,
                  surf_nrm: np.ndarray, k: int = 11):
    """Signed distance by unanimous kNN sign voting.

    :return: (sdf (N,) float64, keep (N,) bool).
    """
    lib = _load()
    q = np.ascontiguousarray(queries, np.float64).reshape(-1, 3)
    p = np.ascontiguousarray(surf_pts, np.float64).reshape(-1, 3)
    n = np.ascontiguousarray(surf_nrm, np.float64).reshape(-1, 3)
    if len(n) != len(p):
        raise ValueError("surf_pts and surf_nrm differ in length")
    out_sdf = np.empty(len(q), np.float64)
    out_keep = np.empty(len(q), np.uint8)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.knn_sign_vote(dptr(q), len(q), dptr(p), dptr(n), len(p), int(k), dptr(out_sdf),
                      out_keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out_sdf, out_keep.astype(bool)
