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

A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version beside it only for a CPU tensor.  ``lane_gather.launches``
counts its kernel launches, ``row_gather.launches_by_c`` its launches per
row width.
"""

from __future__ import annotations

import torch

from . import cuda_build

ROW_WIDTHS = (1, 2, 4)
LANE_MAX = 12288        # one source row in the 48 KB of static shared memory


def row_gather_plain(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return rows[idx.long().clamp(0, rows.shape[0] - 1)]


def lane_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B = src.shape[1]
    j = idx.long()
    j = torch.where(j < 0, j + B, j)
    ok = (j >= 0) & (j < B)
    got = torch.gather(src, 1, j.clamp(0, B - 1))
    return torch.where(ok, got, torch.full_like(got, float("nan")))


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
    for name, t in (("rows", rows), ("out", out)):
        if t.data_ptr() % (4 * C):
            raise ValueError(f"row_gather: {name} is not {4 * C}-byte aligned")
    if M == 0:
        return out
    lib = cuda_build.load("gather")
    cuda_build.check(lib.row_gather(rows.data_ptr(), N, C, idx.data_ptr(), M,
                                    out.data_ptr(), cuda_build.stream_ptr(rows.device)),
                     "row_gather")
    row_gather.launches_by_c[C] += 1
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
    cuda_build.check(lib.lane_gather(src.data_ptr(), idx.data_ptr(), H, B,
                                     out.data_ptr(), cuda_build.stream_ptr(src.device)),
                     "lane_gather")
    lane_gather.launches += 1
    return out


def reset_launches():
    row_gather.launches_by_c = dict.fromkeys(ROW_WIDTHS, 0)
    lane_gather.launches = 0


reset_launches()
