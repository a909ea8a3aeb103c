"""Image-space RGB-D geometry on tensors (the fusion loop's subset).

Counterparts of the JAX package's ``ops/imgproc.py``:

  * ``unproject_depth``         pinhole back-projection, plane-major (3, H, W)
  * ``gradient_xy``             Sobel/8 intensity gradient, NaN on the border
  * ``resize_half_bilinear``    align_corners halving as two blend matmuls
  * ``resize_half_nearest``     even rows/columns of a NaN-invalid depth map
  * ``radius_neighbor_count`` / ``estimate_normals_image``: the windowed
    statistics in plain PyTorch.  They are the CPU path of the stencil
    kernels (``ops.stencil``); pixels outside the image count as invalid.
  * ``box_filter_points_exact`` sort-based voxel-grid mean downsample
  * ``bilateral_depth_filter``  edge-preserving 5x5 depth smoothing (wraps at
    the border, as the JAX version's ``jnp.roll`` does)
  * ``sensor_noise_weight``     per-pixel confidence of the sensor noise model
  * ``radius_outlier_mask_exact`` the exact KD-tree radius-outlier mask on the
    host (scipy), the oracle of the windowed count
  * ``rgb_odometry``            dense photometric residual + 6-DoF Jacobian
  * ``select_photometric_pixels`` / ``rgb_odometry_sparse``: the sparse
    photometric term (top-k gradient pixels once per frame, then one k-row
    warp gather per evaluation)

The TPU layout tricks of the JAX versions (one-hot lane-selection matmuls
for strided slices) are plain slices here: they select the same values.
The gathers go through the gather kernels (``ops.gather``).  The two
photometric terms are the first half of the plain version of the tracker's
photometric kernel (``ops.photometric``), which the tracker calls.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import gather

HALO = 3


def unproject_depth(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """(H, W) metric depth -> (3, H, W) camera-space points (NaN-preserving)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=0)


def gradient_xy(intensity: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (2, H, W) Sobel gradient / 8; NaN on the 1-px border."""
    p = F.pad(intensity[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = ((p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[2:, 2:] - p[2:, :-2])) / 8.0
    gy = ((p[2:, :-2] - p[:-2, :-2]) + 2 * (p[2:, 1:-1] - p[:-2, 1:-1])
          + (p[2:, 2:] - p[:-2, 2:])) / 8.0
    g = torch.stack([gx, gy], dim=0)
    H, W = intensity.shape
    dev = intensity.device
    border = (torch.arange(H, device=dev)[:, None] % (H - 1) == 0) | \
             (torch.arange(W, device=dev)[None, :] % (W - 1) == 0)
    return torch.where(border[None], torch.full_like(g, float("nan")), g)


def _half_resize_weights(n_in: int) -> np.ndarray:
    """(n_in//2, n_in) align_corners bilinear row-resample matrix."""
    n_out = n_in // 2
    x = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (x - lo).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), lo] += 1.0 - f
    M[np.arange(n_out), hi] += f
    return M


@functools.lru_cache(maxsize=None)
def _half_resize_matrix(n_in: int, device: torch.device) -> torch.Tensor:
    """``_half_resize_weights`` on ``device``, copied there once: a copy from
    the host cannot be captured in a CUDA graph."""
    return torch.as_tensor(_half_resize_weights(n_in), device=device)


def resize_half_bilinear(img: torch.Tensor) -> torch.Tensor:
    """Halve H, W with align_corners bilinear; finite inputs only."""
    H, W = img.shape
    Wy = _half_resize_matrix(H, img.device)
    Wx = _half_resize_matrix(W, img.device)
    return (Wy @ img) @ Wx.T


def resize_half_nearest(img: torch.Tensor) -> torch.Tensor:
    """Halve H, W by taking even rows and columns (torch 'nearest' floor
    index).  Contract: a positive image with NaN invalids (a depth map)."""
    z = torch.where(torch.isfinite(img), img, torch.zeros_like(img))[::2, ::2]
    return torch.where(z > 0.0, z, torch.full_like(z, float("nan")))


def bilateral_depth_filter(depth: torch.Tensor, radius: int = 2,
                           sigma_space: float = 1.5, sigma_depth_factor: float = 0.05):
    """Edge-preserving (2 radius + 1)^2 depth smoothing with a range sigma
    that grows with depth; NaN depths stay NaN.  Neighbours wrap around the
    image border (``torch.roll``, the JAX version's ``jnp.roll``)."""
    valid = torch.isfinite(depth)
    d0 = torch.where(valid, depth, torch.zeros_like(depth))
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    sigma_d = sigma_depth_factor * torch.clamp_min(depth, 0.5)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            dn = torch.roll(d0, (dy, dx), dims=(0, 1))
            vn = torch.roll(valid, (dy, dx), dims=(0, 1))
            w = vn * torch.exp(-(dx * dx + dy * dy) / (2 * sigma_space ** 2)
                               - (dn - d0) ** 2 / (2 * sigma_d ** 2))
            acc += w * dn
            wacc += w
    out = acc / torch.clamp_min(wacc, 1e-9)
    return torch.where(valid, out, torch.full_like(out, float("nan")))


def sensor_noise_weight(depth: torch.Tensor, normals: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel observation confidence in (0, 1] from the Kinect axial noise
    model sigma_z = 0.0012 + 0.0019 (z - 0.4)^2 / cos(theta): sigma at 1 m
    head-on over sigma_z, 0 off ``valid``.  ``normals``: (3, H, W) in the
    camera frame (its z component is cos(theta))."""
    cos_t = torch.clamp(torch.abs(normals[2]), 0.05, 1.0)
    sigma = 0.0012 + 0.0019 * (depth - 0.4) ** 2 / cos_t
    sigma_ref = 0.0012 + 0.0019 * 0.36
    w = torch.clamp(sigma_ref / torch.clamp_min(sigma, 1e-6), 0.0, 1.0)
    return torch.where(valid, w, torch.zeros_like(w))


def radius_outlier_mask_exact(points: np.ndarray, nb_points: int = 16,
                              radius: float = 0.05) -> np.ndarray:
    """Exact radius-outlier mask on the host (a KD-tree): keep a point iff at
    least ``nb_points`` others lie within ``radius``.  The oracle the
    windowed ``radius_neighbor_count`` is checked against."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    counts = tree.query_ball_point(points, radius, return_length=True)
    return np.asarray(counts) >= nb_points + 1      # the ball holds the point itself


def window_stats(pts: torch.Tensor, valid: torch.Tensor, radius: float,
                 radius_px: int = HALO, count_only: bool = False):
    """Count / mean / covariance of the valid neighbours within ``radius``
    (3-D) over a (2 radius_px + 1)^2 window, the centre included.

    Pixels outside the image are invalid.  Taps visit the neighbour at
    (y - dy, x - dx) for dy, dx = -r..r (the JAX version's roll order).
    :return: count (H, W) and, unless ``count_only``, mean (3, H, W) and
        cov6 (6, H, W) = (xx, xy, xz, yy, yz, zz).
    """
    r = radius_px
    H, W = valid.shape
    p0 = torch.where(valid[None], pts, torch.zeros_like(pts))
    pp = F.pad(p0, (r, r, r, r))
    vp = F.pad(valid, (r, r, r, r))
    r2 = radius * radius
    cnt = torch.zeros((H, W), dtype=pts.dtype, device=pts.device)
    if not count_only:
        s1 = torch.zeros((3, H, W), dtype=pts.dtype, device=pts.device)
        s2 = torch.zeros((6, H, W), dtype=pts.dtype, device=pts.device)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            pn = pp[:, r - dy:r - dy + H, r - dx:r - dx + W]
            vn = vp[r - dy:r - dy + H, r - dx:r - dx + W]
            e = pn - p0
            dist2 = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
            w = (vn & valid & (dist2 <= r2)).to(pts.dtype)
            cnt += w
            if not count_only:
                s1 += w[None] * pn
                s2 += w[None] * torch.stack([pn[a] * pn[b] for a, b in pairs])
    if count_only:
        return cnt
    denom = torch.clamp_min(cnt, 1.0)
    mean = s1 / denom[None]
    cov6 = s2 / denom[None] - torch.stack([mean[a] * mean[b] for a, b in pairs])
    return cnt, mean, cov6


def sym3_smallest_eigvec(cov6: torch.Tensor) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector (unnormalised) of symmetric 3x3
    fields given as 6 planes: trigonometric eigenvalue (Smith's method),
    then the largest cross product of two rows of (A - lam I)."""
    a00, a01, a02, a11, a12, a22 = (cov6[i] for i in range(6))
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    r0 = torch.stack([a00 - lam, a01, a02], 0)
    r1 = torch.stack([a01, a11 - lam, a12], 0)
    r2 = torch.stack([a02, a12, a22 - lam], 0)
    c01 = torch.linalg.cross(r0, r1, dim=0)
    c02 = torch.linalg.cross(r0, r2, dim=0)
    c12 = torch.linalg.cross(r1, r2, dim=0)
    n01 = torch.sum(c01 * c01, 0, keepdim=True)
    n02 = torch.sum(c02 * c02, 0, keepdim=True)
    n12 = torch.sum(c12 * c12, 0, keepdim=True)
    return torch.where(n01 >= torch.maximum(n02, n12), c01,
                       torch.where(n02 >= n12, c02, c12))


def normals_from_stats(pts: torch.Tensor, cov6: torch.Tensor) -> torch.Tensor:
    """Unit smallest eigenvectors flipped toward the camera at the origin."""
    n = sym3_smallest_eigvec(cov6)
    flip = torch.sum(n * -pts, dim=0, keepdim=True) < 0
    n = torch.where(flip, -n, n)
    norm = torch.sqrt(torch.clamp_min(torch.sum(n * n, dim=0, keepdim=True), 1e-24))
    return n / norm


def radius_neighbor_count(pts: torch.Tensor, valid: torch.Tensor,
                          radius: float, radius_px: int = HALO) -> torch.Tensor:
    """3-D neighbours within ``radius`` inside the window, centre excluded."""
    cnt = window_stats(pts, valid, radius, radius_px, count_only=True)
    return cnt - valid.to(pts.dtype)


def estimate_normals_image(pts: torch.Tensor, valid: torch.Tensor,
                           radius: float = 0.1, radius_px: int = HALO,
                           min_neighbors: int = 5):
    """Windowed-PCA normals, camera-facing; zero where support is thin.

    :return: (normals (3, H, W), normal_valid (H, W)).
    """
    cnt, _, cov6 = window_stats(pts, valid, radius, radius_px)
    n = normals_from_stats(pts, cov6)
    ok = valid & (cnt >= min_neighbors + 1) & torch.isfinite(torch.sum(n, dim=0))
    return torch.where(ok[None], n, torch.zeros_like(n)), ok


_MIX = -1640531535          # odd multiplier: a bijection of int32


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement wrap of its low 32 bits."""
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def box_filter_points_exact(pts: torch.Tensor, normals: torch.Tensor,
                            valid: torch.Tensor, voxel_size: float,
                            capacity: int, extent: float = 8.0,
                            colors: torch.Tensor = None):
    """Exact voxel-grid mean downsample into a fixed ``capacity`` buffer.

    Cells come out in the order of ``(bad, mix(cell id))`` with
    ``mix(g) = int32(g * -1640531535)``, ties in input order: the order of
    the JAX version's two-key stable sort.  The order is load-bearing, as
    the tracker takes the first ``gn_point_budget`` rows.  The multiply is
    done in int64 and wrapped to int32 explicitly; one stable sort of
    ``bad * 2^32 + (mix + 2^31)`` replaces the two-key sort.
    :return: (pts, normals, [colors,] mask (capacity,), drop_frac ()).
    """
    n_cells = int(2 * extent / voxel_size)
    grid = torch.floor((pts + extent) / voxel_size).long()
    inb = torch.all((grid >= 0) & (grid < n_cells), dim=-1) & valid
    gid = (grid[:, 0] * n_cells + grid[:, 1]) * n_cells + grid[:, 2]
    mix = _wrap_int32(_wrap_int32(gid) * _MIX)
    key = (~inb).long() * 2 ** 32 + (mix + 2 ** 31)
    skey, order = torch.sort(key, stable=True)
    ok = skey < 2 ** 32
    first = ok.clone()
    first[1:] &= skey[1:] != skey[:-1]
    rank = torch.cumsum(first, 0) - 1
    n_occ = first.sum()
    dest = torch.where(ok & (rank < capacity), rank, capacity)
    parts = [pts, normals] + ([colors] if colors is not None else [])
    ones = torch.ones((pts.shape[0], 1), dtype=pts.dtype, device=pts.device)
    stacked = torch.cat(parts + [ones], dim=-1)
    acc = torch.zeros((capacity + 1, stacked.shape[1]), dtype=pts.dtype,
                      device=pts.device)
    acc.index_add_(0, dest, stacked[order])
    acc = acc[:capacity]
    c = torch.clamp_min(acc[:, -1:], 1.0)
    out_p = acc[:, 0:3] / c
    out_n = acc[:, 3:6] / c
    nn_ = torch.sqrt(torch.clamp_min(torch.sum(out_n * out_n, -1, keepdim=True), 1e-24))
    out_n = out_n / nn_
    mask = torch.arange(capacity, device=pts.device) < torch.clamp_max(n_occ, capacity)
    n_inb = inb.sum().to(torch.float32)
    n_kept = (dest < capacity).sum().to(torch.float32)
    drop_frac = (n_inb - n_kept) / torch.clamp_min(n_inb, 1.0)
    if colors is None:
        return out_p, out_n, mask, drop_frac
    return out_p, out_n, acc[:, 6:9] / c, mask, drop_frac


def box_filter_points(pts: torch.Tensor, normals: torch.Tensor, valid: torch.Tensor,
                      voxel_size: float, capacity: int, extent: float = 8.0,
                      table_bits: int = 20, colors: torch.Tensor = None):
    """Voxel-grid mean downsample through a hash table (the JAX package's
    ``box_filter_points``, selected by ``preprocess.box_filter_exact: false``).

    Cells hash into a 2^``table_bits`` table by the Knuth multiplier
    ``int32(cell id * -1640531535)`` (wrapped to int32 explicitly); a
    scatter-max takes the owner of each slot (``int32.min`` marks an empty
    one) and the points of a cell that lost its slot to a collision are
    dropped.  Cells come out in slot order (a cumsum of the occupied slots
    ranks them), the order the tracker's point budget reads.  One
    scatter-add of [points | normals | colors | 1] averages each cell.
    ``drop_frac`` is the share of in-bounds points lost to collisions.
    :return: (pts, normals, [colors,] mask (capacity,), drop_frac ()).
    """
    tbl = 1 << table_bits
    empty = torch.iinfo(torch.int32).min
    dev = pts.device
    n_cells = int(2 * extent / voxel_size)
    grid = torch.floor((pts + extent) / voxel_size).long()
    inb = torch.all((grid >= 0) & (grid < n_cells), dim=-1) & valid
    gid = _wrap_int32((grid[:, 0] * n_cells + grid[:, 1]) * n_cells + grid[:, 2])
    h = torch.where(inb, _wrap_int32(gid * _MIX) & (tbl - 1), tbl)
    winner = torch.full((tbl + 1,), empty, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, h, gid, reduce="amax")
    hc = h.clamp_max(tbl - 1)
    mine = inb & (winner[hc] == gid) & (h < tbl)
    occ = winner[:tbl] > empty
    rank = torch.cumsum(occ, 0) - 1
    n_occ = occ.sum()
    prank = rank[hc]
    dest = torch.where(mine & (prank < capacity), prank, capacity)
    parts = [pts, normals] + ([colors] if colors is not None else [])
    ones = torch.ones((pts.shape[0], 1), dtype=pts.dtype, device=dev)
    stacked = torch.cat(parts + [ones], dim=-1)
    acc = torch.zeros((capacity + 1, stacked.shape[1]), dtype=pts.dtype, device=dev)
    acc.index_add_(0, dest, stacked)
    acc = acc[:capacity]
    c = torch.clamp_min(acc[:, -1:], 1.0)
    out_p = acc[:, 0:3] / c
    out_n = acc[:, 3:6] / c
    nn_ = torch.sqrt(torch.clamp_min(torch.sum(out_n * out_n, -1, keepdim=True), 1e-24))
    out_n = out_n / nn_
    mask = torch.arange(capacity, device=dev) < torch.clamp_max(n_occ, capacity)
    n_inb = inb.sum().to(torch.float32)
    drop_frac = (n_inb - mine.sum().to(torch.float32)) / torch.clamp_min(n_inb, 1.0)
    if colors is None:
        return out_p, out_n, mask, drop_frac
    return out_p, out_n, acc[:, 6:9] / c, mask, drop_frac


def intensity_depth_rows(intensity, depth):
    """(H, W) intensity and depth planes -> (H*W, 2) rows [intensity, depth],
    the source of the photometric warp's row gather."""
    return torch.stack([intensity.reshape(-1), depth.reshape(-1)], dim=-1)


def rgb_odometry(prev_rows, cur_intensity, cur_depth,
                 cur_dIdxy, fx, fy, cx, cy, krkinv, kt,
                 min_grad_scale: float, max_depth_delta: float,
                 stride: int = 1):
    """Dense photometric residual + 6-DoF Jacobian.

    The warp takes current pixels into the previous frame with the
    rounded-nearest correspondence (round half to even) and a clipped
    gather.  With ``stride`` > 1 the current frame is evaluated at every
    stride-th pixel: the keep mask is computed at full resolution, the
    planes are zeroed outside it and sliced, and ``d1 > 0`` recovers it.
    :param prev_rows: (H*W, 2) rows of the previous frame, from
        :func:`intensity_depth_rows`.
    :param krkinv: (3, 3) K R K^-1; :param kt: (3,) K t.
    :return: (f (h, w), J (6, h, w), valid (h, w)) at the strided size.
    """
    H, W = cur_intensity.shape
    gx, gy = cur_dIdxy[0], cur_dIdxy[1]
    d1 = cur_depth
    grad2 = gx * gx + gy * gy
    if stride > 1:
        keep = torch.isfinite(grad2) & (grad2 >= min_grad_scale) \
            & torch.isfinite(d1) & torch.isfinite(cur_intensity)
        zero = torch.zeros_like(d1)

        def dec(p):
            return torch.where(keep, p, zero)[::stride, ::stride]

        cur_intensity, d1, gx, gy = (dec(cur_intensity), dec(d1), dec(gx), dec(gy))
        ok = d1 > 0.0
    else:
        ok = torch.isfinite(grad2) & (grad2 >= min_grad_scale) & torch.isfinite(d1)
    h, w = cur_intensity.shape
    dev = cur_intensity.device
    u = (torch.arange(w, dtype=torch.float32, device=dev) * stride)[None, :].expand(h, w)
    v = (torch.arange(h, dtype=torch.float32, device=dev) * stride)[:, None].expand(h, w)

    wz = d1 * (krkinv[2, 0] * u + krkinv[2, 1] * v + krkinv[2, 2]) + kt[2]
    u0 = torch.round((d1 * (krkinv[0, 0] * u + krkinv[0, 1] * v + krkinv[0, 2])
                      + kt[0]) / wz)
    v0 = torch.round((d1 * (krkinv[1, 0] * u + krkinv[1, 1] * v + krkinv[1, 2])
                      + kt[1]) / wz)
    inb, u0c, v0c, lin = _warp_index(u0, v0, W, H)
    got = gather.row_gather_plain(prev_rows, lin.reshape(-1))
    i0 = got[:, 0].reshape(h, w)
    d0 = got[:, 1].reshape(h, w)
    ok = ok & inb & torch.isfinite(d0) & (d0 > 0.0) \
        & (torch.abs(wz - d0) <= max_depth_delta)
    f = torch.where(ok, cur_intensity - i0, torch.zeros_like(i0))
    J = _warp_jacobian(ok, d0, u0c, v0c, gx, gy, fx, fy, cx, cy)
    return f, J, ok


def _warp_index(u0, v0, W: int, H: int):
    """Rounded warp coordinates -> (in-bounds mask, clamped u0 and v0 as
    f32, int32 linear index into the (H*W) source)."""
    inb = (u0 >= 0) & (u0 < W) & (v0 >= 0) & (v0 < H)
    # clamp as floats first: a NaN or infinite warp has no integer value
    u0c = torch.nan_to_num(u0, nan=0.0).clamp(0, W - 1)
    v0c = torch.nan_to_num(v0, nan=0.0).clamp(0, H - 1)
    lin = (v0c.to(torch.int32) * W + u0c.to(torch.int32))
    return inb, u0c, v0c, lin


def _warp_jacobian(ok, d0, u0c, v0c, gx, gy, fx, fy, cx, cy):
    """6-DoF photometric Jacobian (plane-major), zero where not ``ok``."""
    Gx = d0 * (u0c - cx) / fx
    Gy = d0 * (v0c - cy) / fy
    Gz = torch.clamp_min(d0, 1e-6)
    p0 = gx * fx / Gz
    p1 = gy * fy / Gz
    p2 = -(p0 * Gx + p1 * Gy) / Gz
    J = torch.stack([p0, p1, p2,
                     -Gz * p1 + Gy * p2,
                     Gz * p0 - Gx * p2,
                     -Gy * p0 + Gx * p1], dim=0)
    return torch.where(ok[None], J, torch.zeros_like(J))


def select_photometric_pixels(cur_intensity, cur_depth, cur_dIdxy, k: int,
                              min_grad_scale: float, stride: int = 1):
    """Fixed-budget sparse pixel selection for the photometric term.

    The ``k`` pixels on the stride grid with the largest intensity-gradient
    magnitude among those with finite gradient and depth.  The stride is
    folded into the candidate mask; the budget is capped at the number of
    grid pixels (invalid ones included, ``valid`` False).  Equal scores are
    taken lowest index first, as ``lax.top_k`` does: a stable descending
    sort (``torch.topk`` may pick another set among ties).
    :return: (u, v, i1, d1, gx, gy, valid), (kk,) each, full-resolution
        pixel units.
    """
    h, w = cur_intensity.shape
    gx, gy = cur_dIdxy[0], cur_dIdxy[1]
    grad2 = gx * gx + gy * gy
    ok = torch.isfinite(grad2) & (grad2 >= min_grad_scale) & torch.isfinite(cur_depth)
    if stride > 1:
        dev = cur_intensity.device
        ok = ok & (torch.arange(h, device=dev)[:, None] % stride == 0) \
            & (torch.arange(w, device=dev)[None, :] % stride == 0)
    score = torch.where(ok, grad2, torch.full_like(grad2, -1.0)).reshape(-1)
    kk = min(k, ((h - 1) // stride + 1) * ((w - 1) // stride + 1))
    vals, idx = torch.sort(score, descending=True, stable=True)
    # one contiguous vector per output: the photometric kernel reads them so
    return gather.select_gather(vals, idx, kk, w, (cur_intensity, cur_depth, gx, gy))


def rgb_odometry_sparse(prev_rows, W: int, H: int, pix, fx, fy, cx, cy,
                        krkinv, kt, max_depth_delta: float):
    """Photometric residual + Jacobian at a selected pixel set: the math of
    ``rgb_odometry`` on (k,) vectors with one k-row gather.

    :param prev_rows: (H*W, 2) rows of the previous frame, from
        :func:`intensity_depth_rows`.
    :param pix: output of :func:`select_photometric_pixels`.
    :return: (f (k,), J (6, k), ok (k,)).
    """
    u, v, i1, d1, gx, gy, valid = pix
    wz = d1 * (krkinv[2, 0] * u + krkinv[2, 1] * v + krkinv[2, 2]) + kt[2]
    u0 = torch.round((d1 * (krkinv[0, 0] * u + krkinv[0, 1] * v + krkinv[0, 2])
                      + kt[0]) / wz)
    v0 = torch.round((d1 * (krkinv[1, 0] * u + krkinv[1, 1] * v + krkinv[1, 2])
                      + kt[1]) / wz)
    inb, u0c, v0c, lin = _warp_index(u0, v0, W, H)
    got = gather.row_gather_plain(prev_rows, lin)
    i0, d0 = got[:, 0], got[:, 1]
    ok = valid & inb & torch.isfinite(d0) & (d0 > 0.0) \
        & (torch.abs(wz - d0) <= max_depth_delta)
    f = torch.where(ok, i1 - i0, torch.zeros_like(i0))
    J = _warp_jacobian(ok, d0, u0c, v0c, gx, gy, fx, fy, cx, cy)
    return f, J, ok
