"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<digest>.so`` (the digest
is the source's hash, so an edited source rebuilds) and loaded with
``ctypes``.  Nothing here runs at import time: the first wrapper that
launches a kernel builds its library, or ``build_all`` builds every
library at once with one ``nvcc`` process per source, all started
together.  ``_build/`` is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("mlp", "stencil")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every kernel entry returns cudaGetLastError() as an int.
SIGNATURES = {
    "mlp": {
        "decoder_forward": (_P, _P, _I, _P, _P),
        "decoder_forward_grad": (_P, _P, _I, _P, _P, _P),
        "encoder_forward": (_P, _P, _I, _P, _P),
    },
    "stencil": {
        "stencil_normals": (_P, _P, _I, _I, _F, _P, _P, _P),
        "stencil_count": (_P, _P, _I, _I, _F, _P, _P),
    },
}

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    :return: {name: {"seconds": build wall time (0.0 if cached),
                     "ptxas": compiler resource report}}.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {status}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
