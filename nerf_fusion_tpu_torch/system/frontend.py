"""Per-frame RGB-D preprocessing: images -> oriented, outlier-filtered,
voxel-downsampled points + image pyramids.

Counterpart of the JAX package's ``system/frontend.py``.  The two windowed
passes run the stencil kernels (``ops.stencil``): the radius-outlier count
at ``outlier_radius`` and, on the gated mask, the PCA normals at
``normal_radius``.  The kernels count the centre pixel; the gates subtract
it where the reference's neighbour count excludes it.
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


def preprocess_frame(rgb, depth, fx, fy, cx, cy,
                     depth_cut_min, depth_cut_max, point_budget: int,
                     subsample: float = 0.5, depth_scale=1.0,
                     outlier_radius: float = 0.05, outlier_min_nb: int = 16,
                     normal_radius: float = 0.1, normal_min_nb: int = 5,
                     box_filter_size: float = 0.02) -> Preprocessed:
    """rgb (H, W, 3) float in [0, 1] or uint8; depth (H, W) float metres
    (NaN invalid) or uint16 counts at ``depth_scale`` per metre (0 invalid).
    Both on the device the work should run on."""
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) / 255.0
    if depth.dtype != torch.float32:
        d = depth.to(torch.float32) / depth_scale
        depth = torch.where(depth == 0, torch.full_like(d, float("nan")), d)
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
    pts = imgproc.unproject_depth(pc_depth, fx * s, fy * s, cx * s, cy * s)
    valid = torch.isfinite(pc_depth)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts))

    # Radius outlier removal: >= outlier_min_nb neighbours (centre excluded).
    ncount = stencil.neighbor_count(pts0, valid, outlier_radius) - valid.to(torch.float32)
    valid = valid & (ncount >= outlier_min_nb)

    # Windowed-PCA normals on the gated mask, camera-facing.
    normals, cnt = stencil.normals_stencil(pts0, valid, normal_radius)
    nvalid = valid & (cnt >= normal_min_nb + 1) & torch.isfinite(torch.sum(normals, dim=0))
    normals = torch.where(nvalid[None], normals, torch.zeros_like(normals))
    valid = valid & nvalid

    # Box-filter downsample into the fixed budget.
    step = {1.0: 1, 0.5: 2, 0.25: 4}[subsample]
    rgb_pc = rgb[::step, ::step]
    bp, bn, bc, bm, drop = imgproc.box_filter_points_exact(
        pts0.reshape(3, -1).T, normals.reshape(3, -1).T, valid.reshape(-1),
        voxel_size=box_filter_size, capacity=point_budget,
        colors=rgb_pc.reshape(-1, 3))
    return Preprocessed(pyr, bp, bn, bc, bm, drop)
