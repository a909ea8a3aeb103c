"""The gather kernels: wrappers and plain versions.

Counterparts of the Pallas gathers of the JAX package's probes
(``tools/gather_exp3.py``, ``tools/gather_exp4.py``).  The kernels live in
``csrc/gather.cu``:

  * ``row_gather(rows, idx)``  rows (N, C) f32 with C in {1, 2, 4}, or a
    1-D (N,) plane, at (M,) int32 indices -> (M, C) (or (M,)).  Clip mode:
    an index is clamped into [0, N-1], as ``jnp.take(..., mode="clip")``.
  * ``lane_gather(src, idx)``  (H, B) f32 at (H, B) int32 indices ->
    (H, B): ``jnp.take_along_axis(src, idx, axis=1)``.  A negative index
    wraps once (-1 is the last lane); an index >= B or < -B gives NaN.

  * ``select_gather(vals, idx, kk, w, planes)``  the end of the sparse
    photometric term's pixel selection (``imgproc.select_photometric_pixels``):
    from the first ``kk`` entries of a descending sort of the scores, the
    pixel coordinates, the four planes' values at those pixels and the
    validity, as seven (kk,) vectors, in one launch.  It replaces the
    selection's (N, 4) ``row_gather`` and the PyTorch ops around it.

A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version beside it only for a CPU tensor.  ``lane_gather.launches`` and
``select_gather.launches`` count their kernel launches,
``row_gather.launches_by_c`` its launches per row width.

The launch arithmetic of the two gathers is here, as pure functions that the
CPU tests walk (``tests/test_torch_gather_layout.py``): ``row_plan`` (rows a
thread, block, grid), ``row_vector_index`` (whether the index vector loads
as vectors), ``lane_plan``, ``lane_bulk`` and ``lane_schedule`` (the lane
ring's row, slot and barrier parity at each step of a block).
"""

from __future__ import annotations

import torch

from . import cuda_build

ROW_WIDTHS = (1, 2, 4)
# one source row a ring slot: two slots of dynamic shared memory, 96 KB
# (csrc/gather.cu kLaneMax)
LANE_MAX = 12288
SMS = 132               # an H100 SXM's SMs: the plans' default
SM_THREADS = 2048       # resident threads an SM
SM_BLOCKS = 32          # resident blocks an SM
# row_gather: the most rows a thread, the largest block (csrc/gather.cu
# kRowMaxThreads) and the smallest
ROW_MAX_R = 2
ROW_THREADS = 128
ROW_MIN_THREADS = 32
LANE_BLOCKS_PER_SM = 4  # lane_gather's persistent blocks an SM (k)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_plan(m: int, sms: int = SMS) -> tuple:
    """(r, threads, blocks) of a row gather of ``m`` rows, of any width.

    r rows a thread: one, doubled (up to ``ROW_MAX_R``) while one thread a
    group would not fit the card's resident threads, so that the grid is
    one wave and no thread waits out a second round of dependent loads.
    Blocks of ``ROW_THREADS``, halved (down to ``ROW_MIN_THREADS``) while
    the grid would leave an SM without a block.  The grid is at most
    ``sms`` times the blocks an SM holds; the kernel's grid-stride loop
    covers the rest (a second round past 2 x 132 x 2048 rows, which no
    caller sends).  A one-off sweep on the H100 (PERF.md) found no
    row width that wanted more rows a thread inside one wave, and R = 4
    slower than R = 2 at 307200 rows.
    """
    r = 1
    while r < ROW_MAX_R and _cdiv(m, r) > sms * SM_THREADS:
        r *= 2
    t = ROW_THREADS
    while t > ROW_MIN_THREADS and _cdiv(_cdiv(m, r), t) < sms:
        t //= 2
    resident = min(SM_BLOCKS, SM_THREADS // t)
    return r, t, max(1, min(_cdiv(_cdiv(m, r), t), sms * resident))


def row_vector_index(idx_address: int, r: int) -> bool:
    """Whether a thread's ``r`` indices load as one vector: the index vector
    is aligned to ``r`` indices (``idx[1:]`` of an aligned vector is not).
    Groups of r rows align on the output, which the wrapper allocates, so a
    misaligned index vector keeps the vector stores and loads its indices
    one by one (no scalar head: with C < 4 a head would misalign the stores)."""
    return r > 1 and idx_address % (4 * r) == 0


def lane_plan(h: int, sms: int = SMS, k: int = LANE_BLOCKS_PER_SM) -> int:
    """Persistent blocks of the lane gather: min(h, sms * k)."""
    return max(1, min(h, sms * k))


def lane_bulk(b: int, *addresses: int) -> bool:
    """Whether rows of ``b`` lanes arrive by bulk copy: 16-byte rows
    (b % 4 == 0) at 16-byte aligned source, index and output."""
    return b % 4 == 0 and all(a % 16 == 0 for a in addresses)


def lane_schedule(h: int, blocks: int, block: int) -> list:
    """One block's walk of the lane ring: per step i, (row, slot, parity,
    next row or -1).  The step reads ``row`` from ``slot`` = i % 2 after
    waiting for barrier phase ``parity`` = (i // 2) % 2 (the slot's k-th use
    waits for parity k % 2); at its start thread 0 issues the bulk copy of
    ``next`` into the other slot, which the previous step read."""
    steps = []
    for i, row in enumerate(range(block, h, blocks)):
        nxt = row + blocks
        steps.append((row, i % 2, (i // 2) % 2, nxt if nxt < h else -1))
    return steps


def row_gather_plain(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return rows[idx.long().clamp(0, rows.shape[0] - 1)]


def lane_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B = src.shape[1]
    j = idx.long()
    j = torch.where(j < 0, j + B, j)
    ok = (j >= 0) & (j < B)
    got = torch.gather(src, 1, j.clamp(0, B - 1))
    return torch.where(ok, got, torch.full_like(got, float("nan")))


def select_gather_plain(vals, idx, kk: int, w: int, planes):
    """(u, v, i1, d1, gx, gy, valid): the composition the kernel replaces."""
    vals, idx = vals[:kk], idx[:kk]
    valid = vals >= 0.0
    u = (idx % w).to(torch.float32)
    v = (idx // w).to(torch.float32)
    rows = torch.stack([p.reshape(-1) for p in planes], dim=-1)
    cols = row_gather_plain(rows, idx.to(torch.int32)).T.contiguous()
    return u, v, cols[0], cols[1], cols[2], cols[3], valid


def select_gather(vals: torch.Tensor, idx: torch.Tensor, kk: int, w: int, planes):
    """The selected pixels of a sorted score plane.

    :param vals, idx: ``torch.sort(score, descending=True, stable=True)`` of
        the (H*W,) scores (f32, int64).
    :param planes: (intensity, depth, gx, gy), each (H, W) f32 with W = w.
    :return: u, v, i1, d1, gx, gy (kk,) f32 and valid (kk,) bool.
    """
    what = "select_gather"
    planes = tuple(planes)
    n = vals.shape[0] if vals.dim() == 1 else -1
    if vals.dtype != torch.float32 or vals.dim() != 1:
        raise ValueError(f"{what}: vals must be (N,) float32, got {tuple(vals.shape)} "
                         f"{vals.dtype}")
    if idx.dtype != torch.int64 or tuple(idx.shape) != (n,):
        raise ValueError(f"{what}: idx must be ({n},) int64, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if len(planes) != 4 or any(p.dtype != torch.float32 or p.numel() != n
                               or p.dim() != 2 or p.shape[1] != w for p in planes):
        raise ValueError(f"{what}: planes must be four (H, {w}) float32 planes of {n} "
                         "pixels")
    if not 0 <= kk <= n or n >= 2 ** 31:
        raise ValueError(f"{what}: kk {kk} of {n} pixels")
    if cuda_build.on_cpu(what, vals, idx, *planes):
        return select_gather_plain(vals, idx, kk, w, planes)
    dev = vals.device
    vals, idx = vals.contiguous(), idx.contiguous()
    planes = tuple(p.contiguous() for p in planes)
    out = tuple(torch.empty(kk, dtype=torch.float32, device=dev) for _ in range(6))
    valid = torch.empty(kk, dtype=torch.bool, device=dev)
    if kk > 0:
        lib = cuda_build.load("gather")
        cuda_build.check(lib.select_gather(
            vals.data_ptr(), idx.data_ptr(), kk, w, n, *(p.data_ptr() for p in planes),
            *(t.data_ptr() for t in out), valid.data_ptr(), cuda_build.stream_ptr(dev)),
            what)
        cuda_build.count_launch(select_gather)
    return out + (valid,)


def row_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Clip-mode row gather: ``rows[clamp(idx, 0, N-1)]``."""
    if rows.dtype != torch.float32 or rows.dim() not in (1, 2):
        raise ValueError(f"row_gather: rows must be (N,) or (N, C) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    C = 1 if rows.dim() == 1 else rows.shape[1]
    if C not in ROW_WIDTHS:
        raise ValueError(f"row_gather: row width {C} not in {ROW_WIDTHS}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"row_gather: idx must be (M,) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    N, M = rows.shape[0], idx.shape[0]
    if N == 0 and M > 0:
        raise ValueError("row_gather: empty source")
    if max(N, M) >= 2 ** 31:
        raise ValueError("row_gather: more than 2^31 - 1 rows or indices")
    if cuda_build.on_cpu("row_gather", rows, idx):
        return row_gather_plain(rows, idx)
    rows, idx = rows.contiguous(), idx.contiguous()
    out = torch.empty((M,) + tuple(rows.shape[1:]), dtype=torch.float32,
                      device=rows.device)
    for name, t, align in (("rows", rows, 4 * C), ("out", out, 16)):
        if t.data_ptr() % align:
            raise ValueError(f"row_gather: {name} is not {align}-byte aligned")
    if M == 0:
        return out
    lib = cuda_build.load("gather")
    r, threads, blocks = row_plan(M, cuda_build.sm_count(rows.device))
    cuda_build.check(lib.row_gather(rows.data_ptr(), N, C, idx.data_ptr(), M,
                                    out.data_ptr(), r, threads, blocks,
                                    int(row_vector_index(idx.data_ptr(), r)),
                                    cuda_build.stream_ptr(rows.device)),
                     "row_gather")
    cuda_build.count_launch(row_gather, C)
    return out


def lane_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(src, idx, axis=1)`` with JAX's out-of-range rule."""
    if src.dtype != torch.float32 or src.dim() != 2:
        raise ValueError(f"lane_gather: src must be (H, B) float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != tuple(src.shape):
        raise ValueError("lane_gather: idx must be int32 of the shape of src")
    if cuda_build.on_cpu("lane_gather", src, idx):
        return lane_gather_plain(src, idx)
    H, B = src.shape
    if B > LANE_MAX:
        raise ValueError(f"lane_gather: rows of {B} > {LANE_MAX} lanes do not fit "
                         "shared memory")
    src, idx = src.contiguous(), idx.contiguous()
    out = torch.empty_like(src)
    if src.numel() == 0:
        return out
    lib = cuda_build.load("gather")
    bulk = lane_bulk(B, src.data_ptr(), idx.data_ptr(), out.data_ptr())
    cuda_build.check(lib.lane_gather(src.data_ptr(), idx.data_ptr(), H, B, out.data_ptr(),
                                     lane_plan(H, cuda_build.sm_count(src.device)),
                                     int(bulk), cuda_build.stream_ptr(src.device)),
                     "lane_gather")
    cuda_build.count_launch(lane_gather)
    return out


def reset_launches():
    row_gather.launches_by_c = dict.fromkeys(ROW_WIDTHS, 0)
    lane_gather.launches = 0
    select_gather.launches = 0


reset_launches()
