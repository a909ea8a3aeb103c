"""Tile-shape probe of the stencil kernels on the GPU.

    python -m nerf_fusion_tpu_torch.tools.stencil_variants

Builds ``csrc/stencil.cu`` once per shape in ``TILES`` (tile width, tile
height, vertically adjacent pixels a thread: ``-DSTENCIL_TX``, ``-DSTENCIL_TY``,
``-DSTENCIL_PPT``), all ``nvcc`` processes started together, and times the
three entries of each build on the frontend's 320x240 depth plane of a rendered 640x480 frame: device time from a profiler
trace of ``REPS`` calls (``utils.timing.device_ms``).  Beside them it times a
kernel that does nothing, at the grid of the shipped tile: the least a launch
costs on this card.  Every build's count, points and mask must equal the
shipped build's.  Prints each build's registers and spill bytes as ptxas
reports them and the instructions of each kernel in its compiled code
(``cuobjdump -sass``, where the toolkit has it), one line per measurement, and
returns them.  Raises without a GPU.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch

from ..data.synth import SyntheticSequence
from ..ops import cuda_build, imgproc, stencil
from ..utils.timing import device_ms

TILES = ((32, 20, 1), (32, 20, 2), (64, 10, 1), (32, 10, 1), (32, 16, 1), (16, 16, 1),
         (32, 8, 1), (32, 24, 1), (32, 24, 2))
SHIPPED = TILES[0]
REPS = 100
GATES = (0.05, 16, 0.1, 5)   # outlier radius, least neighbours; normal radius, least
EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def _build(tiles=TILES):
    """{tile: (library path, ptxas log)} plus the empty kernel under None."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    empty_src = cuda_build.BUILD_DIR / "empty_kernel.cu"
    empty_src.write_text(EMPTY_SOURCE)
    jobs = {None: (empty_src, [])}
    for tx, ty, ppt in tiles:
        jobs[(tx, ty, ppt)] = (cuda_build.CSRC_DIR / "stencil.cu",
                               [f"-DSTENCIL_TX={tx}", f"-DSTENCIL_TY={ty}",
                                f"-DSTENCIL_PPT={ppt}"])
    procs = {}
    for key, (src, flags) in jobs.items():
        out = cuda_build.BUILD_DIR / ("libempty.so" if key is None
                                      else f"libstencil-{key[0]}x{key[1]}p{key[2]}.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        built[key] = (out, log)
    return built


def _resources(log: str) -> dict:
    """{mode: "N registers, M spill bytes"} from an ``-Xptxas=-v`` log."""
    res, fn, spill = {}, "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif "spill" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            res[_mode(fn)] = f"{regs} registers, {spill} spill bytes"
    return res


def _mode(fn: str) -> str:
    """The entry a mangled ``stencil_kernel<Mode>`` name belongs to."""
    mode = re.search(r"4ModeE(\d)", fn)
    return ("count", "normals", "frontend")[int(mode.group(1))] if mode else fn


def _instructions(lib: Path) -> dict:
    """{mode: instructions in the kernel's SASS}; empty without cuobjdump."""
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return {}
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return {_mode(body.split(None, 1)[0]):
            len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+\S", body, re.M))
            for body in re.split(r"\n\s*Function : ", out)[1:]}


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("stencil_variants measures the GPU; no CUDA device is available")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    fr = SyntheticSequence(n_frames=1, width=640, height=480, device=dev).render_frame(0)
    depth = torch.where((fr.depth < 0.5) | (fr.depth > 5.0), torch.nan, fr.depth)
    d1 = imgproc.resize_half_nearest(depth).contiguous()
    c = fr.calib
    k1 = (c.fx * 0.5, c.fy * 0.5, c.cx * 0.5, c.cy * 0.5)
    H, W = d1.shape
    valid = torch.isfinite(d1)
    pts0 = torch.where(valid[None], imgproc.unproject_depth(d1, *k1), 0.0).contiguous()
    v8 = valid.view(torch.uint8)
    ro, mo, rn, mn = GATES
    gated = stencil.frontend_points_plain(d1, *k1, ro, mo, rn, 0)[2]   # outlier gate only
    stream = cuda_build.stream_ptr(dev)
    built = _build()
    results = {"device": name, "shape": (H, W), "tiles": {}}

    empty = ctypes.CDLL(str(built[None][0])).empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    blocks = -(-W // SHIPPED[0]) * -(-H // SHIPPED[1])
    threads = SHIPPED[0] * SHIPPED[1] // SHIPPED[2]
    results["empty_ms"] = device_ms(lambda: empty(blocks, threads, stream), REPS)
    print(f"{name}: empty kernel, {blocks} blocks of {threads} threads: "
          f"{results['empty_ms']:.4f} ms on the device", flush=True)

    ref = None
    for tile in TILES:
        path, log = built[tile]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in cuda_build.SIGNATURES["stencil"].items():
            getattr(lib, fn).argtypes = list(argtypes)
        cnt = torch.empty((H, W), dtype=torch.float32, device=dev)
        nrm = torch.empty((3, H, W), dtype=torch.float32, device=dev)
        pts = torch.empty_like(nrm)
        mask = torch.empty((H, W), dtype=torch.bool, device=dev)
        g8 = gated.view(torch.uint8)

        def count():
            cuda_build.check(lib.stencil_count(pts0.data_ptr(), v8.data_ptr(), H, W,
                                               ro * ro, cnt.data_ptr(), stream), "count")

        def normals():
            cuda_build.check(lib.stencil_normals(pts0.data_ptr(), g8.data_ptr(), H, W,
                                                 rn * rn, nrm.data_ptr(), cnt.data_ptr(),
                                                 stream), "normals")

        def frontend():
            cuda_build.check(lib.stencil_frontend(
                d1.data_ptr(), H, W, 1.0 / k1[0], 1.0 / k1[1], k1[2], k1[3], ro * ro, float(mo), rn * rn, float(mn + 1),
                pts.data_ptr(), nrm.data_ptr(), mask.data_ptr(), stream), "frontend")

        count()
        out = [cnt.clone()]
        frontend()
        out += [pts.clone(), mask.clone()]
        torch.cuda.synchronize()
        if ref is None:
            ref = out
        elif not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise RuntimeError(f"stencil_variants: tile {tile} differs from tile {TILES[0]}")
        row = {"resources": _resources(log), "sass_instructions": _instructions(path),
               "count_ms": device_ms(count, REPS), "normals_ms": device_ms(normals, REPS),
               "frontend_ms": device_ms(frontend, REPS)}
        label = f"{tile[0]}x{tile[1]}, {tile[2]} px a thread"
        results["tiles"][label] = row
        print(f"{name}: tile {label} at {W}x{H}: count {row['count_ms']:.4f} "
              f"normals {row['normals_ms']:.4f} frontend {row['frontend_ms']:.4f} ms on "
              f"the device; {row['resources']}; SASS instructions "
              f"{row['sass_instructions']}", flush=True)
    return results


if __name__ == "__main__":
    main()
