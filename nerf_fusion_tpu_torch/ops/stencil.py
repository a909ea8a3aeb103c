"""The windowed point-statistics stencil kernels: wrappers and plain versions.

Counterpart of the JAX package's ``ops/pallas_stencil.py``.  The kernel
lives in ``csrc/stencil.cu`` (one template, with and without the
covariance and eigensolve):

  * ``normals_stencil(pts, valid, radius)`` -> (normals (3, H, W) unit and
    camera-facing, count (H, W) f32, centre included)
  * ``neighbor_count(pts, valid, radius)``  -> count (H, W), centre included

Pixels outside the image count as invalid.  A wrapper launches its kernel
for a CUDA tensor (or raises) and takes the plain version beside it
(``imgproc.window_stats``) only for a CPU tensor.  Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from . import cuda_build, imgproc


def normals_stencil_plain(pts: torch.Tensor, valid: torch.Tensor, radius: float):
    cnt, _, cov6 = imgproc.window_stats(pts, valid, radius)
    return imgproc.normals_from_stats(pts, cov6), cnt


def neighbor_count_plain(pts: torch.Tensor, valid: torch.Tensor, radius: float):
    return imgproc.window_stats(pts, valid, radius, count_only=True)


def _check(pts: torch.Tensor, valid: torch.Tensor, what: str) -> bool:
    """Validates the operands; True when they lie on the CPU."""
    if pts.dtype != torch.float32 or pts.dim() != 3 or pts.shape[0] != 3:
        raise ValueError(f"{what}: pts must be (3, H, W) float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(pts.shape[1:]):
        raise ValueError(f"{what}: valid must be a bool (H, W) mask")
    return cuda_build.on_cpu(what, pts, valid)


def normals_stencil(pts: torch.Tensor, valid: torch.Tensor, radius: float = 0.1):
    """(3, H, W) points + (H, W) mask -> (normals (3, H, W), count (H, W))."""
    if _check(pts, valid, "normals_stencil"):
        return normals_stencil_plain(pts, valid, radius)
    pts = pts.contiguous()
    v8 = valid.contiguous().view(torch.uint8)
    _, H, W = pts.shape
    normals = torch.empty_like(pts)
    count = torch.empty((H, W), dtype=torch.float32, device=pts.device)
    lib = cuda_build.load("stencil")
    cuda_build.check(lib.stencil_normals(
        pts.data_ptr(), v8.data_ptr(), H, W, float(radius * radius),
        normals.data_ptr(), count.data_ptr(), cuda_build.stream_ptr(pts.device)),
        "stencil_normals")
    normals_stencil.launches += 1
    return normals, count


def neighbor_count(pts: torch.Tensor, valid: torch.Tensor, radius: float = 0.05):
    """Within-radius windowed neighbour count, centre included."""
    if _check(pts, valid, "neighbor_count"):
        return neighbor_count_plain(pts, valid, radius)
    pts = pts.contiguous()
    v8 = valid.contiguous().view(torch.uint8)
    _, H, W = pts.shape
    count = torch.empty((H, W), dtype=torch.float32, device=pts.device)
    lib = cuda_build.load("stencil")
    cuda_build.check(lib.stencil_count(
        pts.data_ptr(), v8.data_ptr(), H, W, float(radius * radius),
        count.data_ptr(), cuda_build.stream_ptr(pts.device)), "stencil_count")
    neighbor_count.launches += 1
    return count


normals_stencil.launches = 0
neighbor_count.launches = 0
