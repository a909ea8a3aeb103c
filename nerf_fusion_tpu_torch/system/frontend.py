"""Per-frame RGB-D preprocessing: images -> oriented, outlier-filtered,
voxel-downsampled points + image pyramids.

Counterpart of the JAX package's ``system/frontend.py``.  The point-cloud
stage is one stencil kernel (``ops.stencil.frontend_points``): unproject,
the radius-outlier count at ``outlier_radius`` and its gate, the PCA
normals at ``normal_radius`` on the gated mask and the normal gate.  The
kernel counts the centre pixel; the gates subtract it where the
reference's neighbour count excludes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import imgproc, stencil


class Pyramid(NamedTuple):
    intensity: tuple   # 3 levels (H, W)
    depth: tuple       # 3 levels
    gradient: tuple    # 3 levels (2, H, W)


class Preprocessed(NamedTuple):
    pyramid: Pyramid
    points: torch.Tensor     # (M, 3) camera-frame surface points
    normals: torch.Tensor    # (M, 3) camera-frame normals
    colors: torch.Tensor     # (M, 3) mean rgb per box cell
    mask: torch.Tensor       # (M,) bool
    drop_frac: torch.Tensor  # () fraction of points lost to capacity truncation


def frame_to_float(rgb, depth, depth_scale=1.0):
    """A raw frame (uint8 rgb, uint16 depth counts at ``depth_scale`` per
    metre, 0 invalid) as float32 rgb in [0, 1] and depth in metres (NaN
    invalid); float frames pass through.  Each quotient is taken in float64
    and rounded once, which equals the float32 division on every device
    (PyTorch's CUDA kernel multiplies by the rounded reciprocal of a scalar
    divisor, which differs in the last bit); uint16 is widened first, it has
    few CUDA kernels."""
    if rgb.dtype == torch.uint8:
        rgb = (rgb.to(torch.float64) / 255.0).to(torch.float32)
    if depth.dtype != torch.float32:
        counts = depth.to(torch.int32)
        d = (counts.to(torch.float64) / depth_scale).to(torch.float32)
        depth = torch.where(counts == 0, torch.full_like(d, float("nan")), d)
    return rgb, depth


def preprocess_frame(rgb, depth, fx, fy, cx, cy,
                     depth_cut_min, depth_cut_max, point_budget: int,
                     subsample: float = 0.5, depth_scale=1.0,
                     outlier_radius: float = 0.05, outlier_min_nb: int = 16,
                     normal_radius: float = 0.1, normal_min_nb: int = 5,
                     box_filter_size: float = 0.02,
                     box_filter_exact: bool = True) -> Preprocessed:
    """rgb (H, W, 3) float in [0, 1] or uint8; depth (H, W) float metres
    (NaN invalid) or uint16 counts at ``depth_scale`` per metre (0 invalid).
    Both on the device the work should run on.  ``box_filter_exact``: the
    sort-based box filter, else the hash filter (``imgproc.box_filter_points``,
    which drops the points of colliding cells)."""
    rgb, depth = frame_to_float(rgb, depth, depth_scale)
    intensity = torch.mean(rgb, dim=-1)
    depth = torch.where((depth < depth_cut_min) | (depth > depth_cut_max),
                        torch.full_like(depth, float("nan")), depth)

    i0 = intensity
    i1 = imgproc.resize_half_bilinear(i0)
    i2 = imgproc.resize_half_bilinear(i1)
    d0 = depth
    d1 = imgproc.resize_half_nearest(d0)
    d2 = imgproc.resize_half_nearest(d1)
    pyr = Pyramid((i0, i1, i2), (d0, d1, d2),
                  tuple(imgproc.gradient_xy(i) for i in (i0, i1, i2)))

    # Point-cloud path at `subsample` scale, plane-major (3, H, W).
    if subsample not in (1.0, 0.5, 0.25):
        raise ValueError("supported depth subsample scales: 1, 0.5, 0.25")
    pc_depth = {1.0: d0, 0.5: d1, 0.25: d2}[subsample]
    s = subsample
    pts0, normals, valid = stencil.frontend_points(
        pc_depth, fx * s, fy * s, cx * s, cy * s, outlier_radius, outlier_min_nb,
        normal_radius, normal_min_nb)

    # Box-filter downsample into the fixed budget.
    step = {1.0: 1, 0.5: 2, 0.25: 4}[subsample]
    rgb_pc = rgb[::step, ::step]
    box_fn = imgproc.box_filter_points_exact if box_filter_exact \
        else imgproc.box_filter_points
    bp, bn, bc, bm, drop = box_fn(
        pts0.reshape(3, -1).T, normals.reshape(3, -1).T, valid.reshape(-1),
        voxel_size=box_filter_size, capacity=point_budget,
        colors=rgb_pc.reshape(-1, 3))
    return Preprocessed(pyr, bp, bn, bc, bm, drop)
