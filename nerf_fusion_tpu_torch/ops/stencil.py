"""The windowed point-statistics stencil kernels: wrappers and plain versions.

Counterpart of the JAX package's ``ops/pallas_stencil.py``.  The kernel
lives in ``csrc/stencil.cu`` (one template, three entries):

  * ``normals_stencil(pts, valid, radius)`` -> (normals (3, H, W) unit and
    camera-facing, count (H, W) f32, centre included)
  * ``neighbor_count(pts, valid, radius)``  -> count (H, W), centre included
  * ``frontend_points(depth, fx, fy, cx, cy, outlier_radius, outlier_min_nb,
    normal_radius, normal_min_nb)`` -> (pts0 (3, H, W), normals (3, H, W),
    valid (H, W) bool): the frontend's whole point-cloud stage in one
    launch (unproject, outlier count and gate, normals on the gated mask,
    normal gate), which is what ``preprocess_frame`` calls.

Pixels outside the image count as invalid.  A wrapper launches its kernel
for a CUDA tensor (or raises) and takes the plain version beside it only
for a CPU tensor.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.
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
    cuda_build.count_launch(normals_stencil)
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
    cuda_build.count_launch(neighbor_count)
    return count


def _compose(depth, fx, fy, cx, cy, outlier_radius, outlier_min_nb,
             normal_radius, normal_min_nb, count_fn, normals_fn):
    """The point-cloud stage step by step, around a count and a normals
    function of the two standalone stencils' contract."""
    pts = imgproc.unproject_depth(depth, fx, fy, cx, cy)
    valid = torch.isfinite(depth)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts))

    # Radius outlier removal: >= outlier_min_nb neighbours (centre excluded).
    ncount = count_fn(pts0, valid, outlier_radius) - valid.to(torch.float32)
    valid = valid & (ncount >= outlier_min_nb)

    # Windowed-PCA normals on the gated mask, camera-facing.
    normals, cnt = normals_fn(pts0, valid, normal_radius)
    nvalid = valid & (cnt >= normal_min_nb + 1) & torch.isfinite(torch.sum(normals, dim=0))
    normals = torch.where(nvalid[None], normals, torch.zeros_like(normals))
    valid = valid & nvalid
    return pts0, normals, valid


def frontend_points_plain(depth, fx, fy, cx, cy, outlier_radius: float = 0.05,
                          outlier_min_nb: int = 16, normal_radius: float = 0.1,
                          normal_min_nb: int = 5):
    return _compose(depth, fx, fy, cx, cy, outlier_radius, outlier_min_nb,
                    normal_radius, normal_min_nb, neighbor_count_plain,
                    normals_stencil_plain)


def frontend_points_unfused(depth, fx, fy, cx, cy, outlier_radius: float = 0.05,
                            outlier_min_nb: int = 16, normal_radius: float = 0.1,
                            normal_min_nb: int = 5):
    """The same stage through the two standalone kernels with PyTorch ops
    between them: what ``frontend_points`` fuses, kept for the frontend
    probe to time."""
    return _compose(depth, fx, fy, cx, cy, outlier_radius, outlier_min_nb,
                    normal_radius, normal_min_nb, neighbor_count, normals_stencil)


def frontend_points(depth: torch.Tensor, fx, fy, cx, cy,
                    outlier_radius: float = 0.05, outlier_min_nb: int = 16,
                    normal_radius: float = 0.1, normal_min_nb: int = 5):
    """(H, W) metric depth (NaN invalid) and its intrinsics -> (pts0 (3, H, W),
    zero where the depth is not finite; normals (3, H, W), zero off the
    final mask; valid (H, W) bool, the final mask)."""
    if depth.dtype != torch.float32 or depth.dim() != 2:
        raise ValueError(f"frontend_points: depth must be (H, W) float32, got "
                         f"{tuple(depth.shape)} {depth.dtype}")
    if cuda_build.on_cpu("frontend_points", depth):
        return frontend_points_plain(depth, fx, fy, cx, cy, outlier_radius,
                                     outlier_min_nb, normal_radius, normal_min_nb)
    depth = depth.contiguous()
    H, W = depth.shape
    pts0 = torch.empty((3, H, W), dtype=torch.float32, device=depth.device)
    normals = torch.empty_like(pts0)
    valid = torch.empty((H, W), dtype=torch.bool, device=depth.device)
    lib = cuda_build.load("stencil")
    # PyTorch divides a CUDA tensor by a Python scalar as a product with the
    # scalar's reciprocal, taken in float64 and rounded to float32; the kernel
    # multiplies by the same number, so its points are the plain version's.
    cuda_build.check(lib.stencil_frontend(
        depth.data_ptr(), H, W, 1.0 / float(fx), 1.0 / float(fy), float(cx), float(cy),
        float(outlier_radius * outlier_radius), float(outlier_min_nb),
        float(normal_radius * normal_radius), float(normal_min_nb + 1),
        pts0.data_ptr(), normals.data_ptr(), valid.data_ptr(),
        cuda_build.stream_ptr(depth.device)), "stencil_frontend")
    cuda_build.count_launch(frontend_points)
    return pts0, normals, valid


normals_stencil.launches = 0
neighbor_count.launches = 0
frontend_points.launches = 0
