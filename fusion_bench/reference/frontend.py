"""The frame's preprocessing in plain PyTorch: pyramids, the oriented point
cloud and its voxel-grid downsample.

Depth outside the cut is invalid (NaN).  Intensity is the mean of rgb; its
pyramid halves with align-corners bilinear resampling, depth's takes even
rows and columns.  The gradient is Sobel / 8, NaN on the border.  The
point cloud is taken at half resolution: back-projected, kept where at
least ``outlier_min_nb`` other valid points lie within ``outlier_radius``
in a 7x7 window, oriented by the smallest eigenvector of the windowed
covariance of the kept points within ``normal_radius`` (at least
``normal_min_nb`` others, facing the camera), and averaged per 2 cm box
into a buffer of ``capacity`` rows in the order of a hash of the box id
(``int32(id * -1640531535)``, ties by input order): the tracker uses the
buffer's first rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import F32, Precision

HALO = 3
_MIX = -1640531535


def _half_matrix(n_in: int, device) -> torch.Tensor:
    n_out = n_in // 2
    x = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (x - lo).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), lo] += 1.0 - f
    M[np.arange(n_out), hi] += f
    return torch.as_tensor(M, device=device)


def resize_bilinear(img, prec: Precision):
    H, W = img.shape
    return prec.mm(prec.mm(_half_matrix(H, img.device), img), _half_matrix(W, img.device).T)


def resize_nearest(img):
    z = torch.where(torch.isfinite(img), img, torch.zeros_like(img))[::2, ::2]
    return torch.where(z > 0.0, z, torch.full_like(z, float("nan")))


def gradient(intensity):
    p = F.pad(intensity[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = ((p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[2:, 2:] - p[2:, :-2])) / 8.0
    gy = ((p[2:, :-2] - p[:-2, :-2]) + 2 * (p[2:, 1:-1] - p[:-2, 1:-1])
          + (p[2:, 2:] - p[:-2, 2:])) / 8.0
    g = torch.stack([gx, gy], 0)
    H, W = intensity.shape
    dev = intensity.device
    border = (torch.arange(H, device=dev)[:, None] % (H - 1) == 0) | \
             (torch.arange(W, device=dev)[None, :] % (W - 1) == 0)
    return torch.where(border[None], torch.full_like(g, float("nan")), g)


def window_stats(pts, valid, radius: float, count_only: bool = False):
    """Count, mean and covariance (xx, xy, xz, yy, yz, zz) of the valid
    neighbours within ``radius`` in a 7x7 window, the centre included.  The
    moments are taken of the offsets from the centre point (the shifted-data
    form): about the origin, E[p p^T] - E[p] E[p]^T of points some metres
    away loses the centimetre-scale covariance to cancellation in float32."""
    r = HALO
    H, W = valid.shape
    p0 = torch.where(valid[None], pts, torch.zeros_like(pts))
    pp = F.pad(p0, (r, r, r, r))
    vp = F.pad(valid, (r, r, r, r))
    cnt = torch.zeros((H, W), dtype=pts.dtype, device=pts.device)
    s1 = torch.zeros((3, H, W), dtype=pts.dtype, device=pts.device)
    s2 = torch.zeros((6, H, W), dtype=pts.dtype, device=pts.device)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            pn = pp[:, r - dy:r - dy + H, r - dx:r - dx + W]
            vn = vp[r - dy:r - dy + H, r - dx:r - dx + W]
            e = pn - p0
            d2 = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
            w = (vn & valid & (d2 <= radius * radius)).to(pts.dtype)
            cnt += w
            if not count_only:
                s1 += w[None] * e
                s2 += w[None] * torch.stack([e[a] * e[b] for a, b in pairs])
    if count_only:
        return cnt
    denom = torch.clamp_min(cnt, 1.0)
    mean = s1 / denom[None]
    cov = s2 / denom[None] - torch.stack([mean[a] * mean[b] for a, b in pairs])
    return cnt, p0 + mean, cov


def eigenvalues(cov6):
    """The eigenvalues (smallest, middle, largest) of 3x3 symmetric fields,
    by the trigonometric formula (Smith)."""
    a00, a01, a02, a11, a12, a22 = (cov6[i] for i in range(6))
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    det = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
           + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    hi = q + 2.0 * p * torch.cos(phi)
    return lo, 3.0 * q - lo - hi, hi


def smallest_eigvec(cov6):
    """Unnormalised eigenvector of the smallest eigenvalue of 3x3 symmetric
    fields (trigonometric eigenvalue, then the largest cross product of two
    rows of A - lambda I)."""
    a00, a01, a02, a11, a12, a22 = (cov6[i] for i in range(6))
    lam = eigenvalues(cov6)[0]
    r0 = torch.stack([a00 - lam, a01, a02], 0)
    r1 = torch.stack([a01, a11 - lam, a12], 0)
    r2 = torch.stack([a02, a12, a22 - lam], 0)
    c01 = torch.linalg.cross(r0, r1, dim=0)
    c02 = torch.linalg.cross(r0, r2, dim=0)
    c12 = torch.linalg.cross(r1, r2, dim=0)
    n01, n02, n12 = (torch.sum(c * c, 0, keepdim=True) for c in (c01, c02, c12))
    return torch.where(n01 >= torch.maximum(n02, n12), c01,
                       torch.where(n02 >= n12, c02, c12))


def point_cloud(depth, fx, fy, cx, cy, cfg: dict, q):
    """(pts0 (3, H, W), normals (3, H, W), valid (H, W), conditioning (2, H,
    W)) of a depth plane; ``q`` rounds each stage's result to the computing
    precision.  Conditioning: how well the data fix each normal: the gap of
    the two smallest eigenvalues over the largest (the direction), and the
    cosine between the normal and the view ray (its sign, which turns it to
    face the camera)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    pts = q(torch.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth], 0))
    valid = torch.isfinite(depth)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts))
    ncount = q(window_stats(pts0, valid, cfg["outlier_radius"], count_only=True)) \
        - valid.to(torch.float32)
    valid = valid & (ncount >= cfg["outlier_min_nb"])
    cnt, _, cov6 = window_stats(pts0, valid, cfg["normal_radius"])
    n = q(smallest_eigvec(q(cov6)))
    n = torch.where(torch.sum(n * -pts0, 0, keepdim=True) < 0, -n, n)
    n = q(n / torch.sqrt(torch.clamp_min(torch.sum(n * n, 0, keepdim=True), 1e-24)))
    lo, mid, hi = eigenvalues(cov6)
    facing = torch.sum(n * pts0, 0).abs() / torch.clamp_min(
        torch.linalg.vector_norm(pts0, dim=0), 1e-12)
    cond = torch.stack([(mid - lo) / torch.clamp_min(hi, 1e-30), facing], 0)
    nvalid = valid & (cnt >= cfg["normal_min_nb"] + 1) & torch.isfinite(torch.sum(n, 0))
    n = torch.where(nvalid[None], n, torch.zeros_like(n))
    return pts0, n, valid & nvalid, cond


def _wrap32(v):
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def box_filter(pts, normals, valid, colors, voxel: float, capacity: int, q,
               extent: float = 8.0, cond=None):
    """Mean per box into ``capacity`` rows: (pts, normals, colors, mask, the
    box key of each row (-1 where empty), its conditioning: the length of
    its mean normal before it is made unit (how far its pixels' normals
    agree) and the least of each ``cond`` column (N, k) over its pixels)."""
    n_cells = int(2 * extent / voxel)
    grid = torch.floor((pts + extent) / voxel).long()
    inb = torch.all((grid >= 0) & (grid < n_cells), -1) & valid
    gid = (grid[:, 0] * n_cells + grid[:, 1]) * n_cells + grid[:, 2]
    key = (~inb).long() * 2 ** 32 + (_wrap32(_wrap32(gid) * _MIX) + 2 ** 31)
    skey, order = torch.sort(key, stable=True)
    ok = skey < 2 ** 32
    first = ok.clone()
    first[1:] &= skey[1:] != skey[:-1]
    rank = torch.cumsum(first, 0) - 1
    dest = torch.where(ok & (rank < capacity), rank, capacity)
    ones = torch.ones((pts.shape[0], 1), dtype=pts.dtype, device=pts.device)
    stacked = torch.cat([pts, normals, colors, ones], -1)
    acc = torch.zeros((capacity + 1, stacked.shape[1]), dtype=pts.dtype, device=pts.device)
    acc.index_add_(0, dest, stacked[order])
    acc = acc[:capacity]
    c = torch.clamp_min(acc[:, -1:], 1.0)
    out_n = q(acc[:, 3:6] / c)
    out_n = q(out_n / torch.sqrt(torch.clamp_min(torch.sum(out_n * out_n, -1, keepdim=True),
                                                 1e-24)))
    mask = torch.arange(capacity, device=pts.device) < torch.clamp_max(first.sum(), capacity)
    keys = torch.full((capacity,), -1, dtype=torch.int64, device=pts.device)
    row_keys = skey[first][:capacity]
    keys[:row_keys.shape[0]] = row_keys
    coherence = torch.linalg.vector_norm(acc[:, 3:6] / c, dim=-1)[:, None]
    if cond is not None:
        least = torch.full((capacity + 1, cond.shape[1]), math.inf, dtype=cond.dtype,
                           device=cond.device)
        least.scatter_reduce_(0, dest[:, None].expand(-1, cond.shape[1]), cond[order],
                              reduce="amin")
        coherence = torch.cat([coherence, least[:capacity]], 1)
    return q(acc[:, 0:3] / c), out_n, q(acc[:, 6:9] / c), mask, keys, coherence


def preprocess(rgb, depth, calib, cfg: dict, capacity: int, prec: Precision = F32) -> dict:
    """One frame: ``intensity``, ``depth``, ``gradient`` (three levels each),
    ``points``, ``normals``, ``mask`` (``capacity`` rows)."""
    q = (lambda x: x.to(prec.ew_dtype).to(torch.float32)) if prec.control else (lambda x: x)
    rgb, depth = q(rgb), q(depth)
    intensity = q(torch.mean(rgb, -1))
    depth = torch.where((depth < cfg["depth_cut_min"]) | (depth > cfg["depth_cut_max"]),
                        torch.full_like(depth, float("nan")), depth)
    i = [intensity]
    d = [depth]
    for _ in range(2):
        i.append(q(resize_bilinear(i[-1], prec)))
        d.append(resize_nearest(d[-1]))
    g = [q(gradient(x)) for x in i]
    s = cfg["subsample"]
    step = {1.0: 1, 0.5: 2, 0.25: 4}[s]
    pc_depth = d[{1: 0, 2: 1, 4: 2}[step]]
    pts0, normals, valid, cond = point_cloud(pc_depth, calib["fx"] * s, calib["fy"] * s,
                                       calib["cx"] * s, calib["cy"] * s, cfg, q)
    bp, bn, bc, bm, keys, conditioning = box_filter(
        pts0.reshape(3, -1).T, normals.reshape(3, -1).T, valid.reshape(-1),
        rgb[::step, ::step].reshape(-1, 3), cfg["box_filter_size"], capacity, q,
        cond=cond.reshape(2, -1).T)
    return {"intensity": i, "depth": d, "gradient": g, "points": bp, "normals": bn,
            "colors": bc, "mask": bm, "keys": keys, "conditioning": conditioning}
