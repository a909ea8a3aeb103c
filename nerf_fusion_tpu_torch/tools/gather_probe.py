"""Gather probe on the GPU: the row gather and the lane gather alone.

    python -m nerf_fusion_tpu_torch.tools.gather_probe

The port's counterpart of the JAX package's ``tools/gather_exp3.py`` and
``tools/gather_exp4.py``, at their shapes (a 640x480 frame):

  * ``row_gather`` at N = M = 307200 for row widths 1, 2 and 4, on
    warp-like indices (identity plus a small displacement, two rows up or
    down at most, clipped into the image);
  * ``lane_gather`` on (480, B) operands for B in 1280, 1920, 3200, 5120
    with indices in [0, B);
  * the window build of the lane-gather idea: five row-shifted copies of
    a (480, 640) image side by side, (480, 3200), in plain PyTorch;
  * the latency floor of a gather on this card: a kernel that does
    nothing (one warp), and one warp that loads an index, then the source
    value it names, and stores it: two dependent trips to device memory
    with the L2 flushed before each call.  No gather kernel can take less
    than the second, whatever its bytes (both in ``csrc/gather_floor.cu``);
  * the row gathers at the probe's indices and the (480, 3200) lane gather
    again, after a flush that only reads (``clean_flush``): the copy of
    ``utils.timing.l2_flush`` leaves dirty lines that a timed call pays to
    write back, a read leaves none.

Each kernel is held bit-exact against its plain version and timed beside
the one PyTorch call that computes the same function (``index_select``
on the in-range indices, ``torch.gather``), all with the L2 flushed before
each call (``utils.timing.l2_flush``): device time from a profiler trace of
``REPS`` calls (``utils.timing.device_ms``), and for the kernel also the
call time between CUDA events (``utils.timing.call_ms``).

Prints one line per measurement and returns them.  Raises without a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_build, gather
from ..utils.timing import call_ms, device_ms, l2_flush

H, W = 480, 640
LANE_WIDTHS = (1280, 1920, 3200, 5120)
REPS = 50


def warp_indices(rng: np.random.Generator, n: int = H * W, w: int = W) -> np.ndarray:
    """Near-identity warp indices into an n-pixel, w-wide image."""
    base = np.arange(n, dtype=np.int64)
    disp = (rng.normal(size=n) * 3).astype(np.int64)
    return np.clip(base + disp + w * rng.integers(-2, 3, n), 0, n - 1).astype(np.int32)


def _check(name: str, out: torch.Tensor, ref: torch.Tensor):
    na, nb = torch.isnan(out), torch.isnan(ref)
    if not (torch.equal(na, nb) and torch.equal(out[~na], ref[~nb])):
        raise RuntimeError(f"gather_probe: {name} differs from its plain version")


def clean_flush(dev, nbytes: int = 128 << 20):
    """A flush for ``device_ms`` that reads ``nbytes`` of zeros through the
    L2 and writes nothing: it leaves the L2 full of clean lines, where
    ``utils.timing.l2_flush``'s copy leaves the lines of its destination
    dirty, so that a timed call also pays for writing them back."""
    lib = cuda_build.load("gather_floor")
    buf = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    stream = cuda_build.stream_ptr(dev)

    def flush():
        cuda_build.check(lib.clean_flush(buf.data_ptr(), nbytes // 16, sink.data_ptr(),
                                         stream), "clean_flush")

    flush.events = ("clean_flush_kernel",)
    return flush


def latency_floor(dev, flush) -> dict:
    """Device ms of an empty kernel and of one warp's index-then-source
    chain, the L2 flushed before each call."""
    lib = cuda_build.load("gather_floor")
    stream = cuda_build.stream_ptr(dev)
    n = H * W
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, n, 32).astype(np.int32), device=dev)
    src = torch.randn(n, device=dev)
    out = torch.empty(32, device=dev)
    cuda_build.check(lib.chain(idx.data_ptr(), src.data_ptr(), out.data_ptr(), stream),
                     "chain")
    _check("chain", out, src[idx.long()])
    res = {"empty_ms": device_ms(lambda: lib.empty(stream), REPS, flush),
           "chain_ms": device_ms(lambda: lib.chain(idx.data_ptr(), src.data_ptr(),
                                                   out.data_ptr(), stream), REPS, flush)}
    print(f"{torch.cuda.get_device_name(0)}: latency floor, L2 flushed: empty kernel "
          f"(1 warp) {res['empty_ms']:.4f} ms, index -> source chain (1 warp) "
          f"{res['chain_ms']:.4f} ms on the device", flush=True)
    return res


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("gather_probe measures the GPU; no CUDA device is available")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    flush = l2_flush(dev)
    rng = np.random.default_rng(0)
    rows2 = torch.as_tensor(rng.normal(size=(H * W, 2)).astype(np.float32), device=dev)
    idx = torch.as_tensor(warp_indices(rng), device=dev)
    idx64 = idx.long()
    results = {"device": name, "row_gather": [], "lane_gather": []}
    sources = {1: rows2[:, 0].contiguous(), 2: rows2,
               4: torch.cat([rows2, rows2], dim=1).contiguous()}
    for C, src in sources.items():
        _check(f"row_gather C={C}", gather.row_gather(src, idx),
               gather.row_gather_plain(src, idx))
        ms = device_ms(lambda: gather.row_gather(src, idx), REPS, flush)
        call = call_ms(lambda: gather.row_gather(src, idx), REPS)
        lib = device_ms(lambda: torch.index_select(src, 0, idx64), REPS, flush)
        results["row_gather"].append({"C": C, "N": src.shape[0], "M": idx.shape[0],
                                      "ms": ms, "call_ms": call, "library_ms": lib})
        print(f"{name}: row_gather ({src.shape[0]}, {C}) at {idx.shape[0]} indices: "
              f"kernel {ms:.4f} ms on the device ({call:.4f} ms per call), "
              f"index_select {lib:.4f} ms on the device (L2 flushed)", flush=True)
    for B in LANE_WIDTHS:
        src = torch.as_tensor(rng.normal(size=(H, B)).astype(np.float32), device=dev)
        lidx = torch.as_tensor(rng.integers(0, B, (H, B)).astype(np.int32), device=dev)
        lidx64 = lidx.long()
        _check(f"lane_gather B={B}", gather.lane_gather(src, lidx),
               gather.lane_gather_plain(src, lidx))
        ms = device_ms(lambda: gather.lane_gather(src, lidx), REPS, flush)
        call = call_ms(lambda: gather.lane_gather(src, lidx), REPS)
        lib = device_ms(lambda: torch.gather(src, 1, lidx64), REPS, flush)
        results["lane_gather"].append({"H": H, "B": B, "ms": ms, "call_ms": call,
                                       "library_ms": lib})
        print(f"{name}: lane_gather ({H}, {B}): kernel {ms:.4f} ms on the device "
              f"({call:.4f} ms per call), torch.gather {lib:.4f} ms on the device "
              f"(L2 flushed)", flush=True)
    img = torch.as_tensor(rng.normal(size=(H, W)).astype(np.float32), device=dev)

    def build():
        return torch.cat([torch.roll(img, -k, dims=0) for k in range(-2, 3)], dim=1)

    ms = device_ms(build, REPS)
    results["window_build_ms"] = ms
    print(f"{name}: window build, 5 row-shifted copies -> ({H}, {5 * W}): "
          f"{ms:.4f} ms on the device (plain PyTorch)", flush=True)
    results["floor"] = latency_floor(dev, flush)
    # the same gathers after a flush that leaves no dirty line in the L2
    clean = clean_flush(dev)
    results["clean_flush"] = {}
    for C, src in sources.items():
        ms = device_ms(lambda: gather.row_gather(src, idx), REPS, clean)
        lib = device_ms(lambda: torch.index_select(src, 0, idx64), REPS, clean)
        results["clean_flush"][f"row_gather_c{C}"] = {"ms": ms, "library_ms": lib}
        print(f"{name}: row_gather ({src.shape[0]}, {C}) at {idx.shape[0]} indices, L2 "
              f"flushed clean: kernel {ms:.4f} ms, index_select {lib:.4f} ms on the device",
              flush=True)
    B = 3200
    src = torch.as_tensor(rng.normal(size=(H, B)).astype(np.float32), device=dev)
    lidx = torch.as_tensor(rng.integers(0, B, (H, B)).astype(np.int32), device=dev)
    lidx64 = lidx.long()
    ms = device_ms(lambda: gather.lane_gather(src, lidx), REPS, clean)
    lib = device_ms(lambda: torch.gather(src, 1, lidx64), REPS, clean)
    results["clean_flush"]["lane_gather"] = {"ms": ms, "library_ms": lib}
    print(f"{name}: lane_gather ({H}, {B}), L2 flushed clean: kernel {ms:.4f} ms, "
          f"torch.gather {lib:.4f} ms on the device", flush=True)
    return results


if __name__ == "__main__":
    main()
