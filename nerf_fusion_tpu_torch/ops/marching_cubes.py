"""Sparse marching cubes with cross-voxel interpolation, on tensors.

Counterpart of the JAX package's ``ops/marching_cubes.py`` (same
semantics, same triangle order):

  * every meshed voxel carries a ``(2r)^3`` decoder sample grid spanning a
    half-voxel margin on each side;
  * a cell-corner value blends the estimates of the owning voxel and its
    lower/upper neighbours per axis, each weighted by its predicted std;
    missing neighbour sources drop out of the weighted sum;
  * rows whose own voxel is absent from the indexer or the batch emit
    nothing (the reference's dominant-source kill);
  * triangles with any vertex std above ``max_std`` are pruned;
  * triangles are compacted by prefix-sum rank into a fixed budget, in
    (cell, triangle) order, each tagged with its voxel's flat id.

The JAX version's TPU layout tricks (blend matrices on the matrix unit,
complex packing, one-hot table matmuls) are plain gathers here: they
select and weight the same values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import voxel as vox
from .mc_tables import CORNERS, EDGE_CORNERS, MAX_TRIS_PER_CELL, TRI_TABLE


class MCResult(NamedTuple):
    vertices: torch.Tensor       # (budget, 3, 3) world-space triangle vertices
    vertex_std: torch.Tensor     # (budget, 3)
    flatten_id: torch.Tensor     # (budget,) owning voxel flat id (-1 empty)
    valid: torch.Tensor          # (budget,) bool
    n_triangles: torch.Tensor    # () pre-clamp count
    cells_dropped: torch.Tensor  # () bool: active-cell budget overflowed


_OFFSETS27 = np.array([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                       for dz in (-1, 0, 1)], np.int64)


@functools.lru_cache(maxsize=None)
def _corner_blend_mats(r: int):
    """Sources of the cross-voxel corner interpolation.

    Each corner ``p`` of the ``(r+1)^3`` lattice blends 8 sources (one per
    choice of lower/upper neighbour on each axis); source ``k`` reads the
    sample ``flat[k, p]`` of the voxel at offset ``_OFFSETS27[off[k, p]]``
    with weight ``w[k, p]``.
    :return: (off (8, P) int64, flat (8, P) int64, w (8, P) f32).
    """
    rp = np.arange(r + 1)
    rpx, rpy, rpz = np.meshgrid(rp, rp, rp, indexing="ij")
    rpos = np.stack([rpx, rpy, rpz], -1).reshape(-1, 3)               # (P, 3)
    rbound = (r - 1) // 2
    rstart = r // 2
    rmid = r / 2.0
    lower = rpos <= rbound
    off_m = np.where(lower, -1, 0)
    off_p = np.where(lower, 0, 1)
    idx_m = np.where(lower, rpos + r + rstart, rpos + rstart)
    idx_p = np.where(lower, rpos + rstart, rpos + rstart - r)
    w_m = np.where(lower, rmid - rpos, rmid + r - rpos) / r
    w_p = np.where(lower, rpos + rmid, rpos - rmid) / r
    n = 2 * r
    offs, flats, ws = [], [], []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = (sx, sy, sz)
                off = np.stack([(off_p if s else off_m)[:, a]
                                for a, s in enumerate(sel)], -1)      # (P, 3)
                idx = np.stack([(idx_p if s else idx_m)[:, a]
                                for a, s in enumerate(sel)], -1)
                w = ((w_p if sx else w_m)[:, 0] * (w_p if sy else w_m)[:, 1]
                     * (w_p if sz else w_m)[:, 2])
                offs.append(((off[:, 0] + 1) * 3 + off[:, 1] + 1) * 3 + off[:, 2] + 1)
                flats.append((idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2])
                ws.append(w)
    return (np.stack(offs).astype(np.int64), np.stack(flats).astype(np.int64),
            np.stack(ws).astype(np.float32))


def _corner_field(indexer, batch_map, positions_b, cube_sdf, cube_std,
                  n_xyz, r: int, latent_capacity: int):
    """Interpolated (sdf, std) at the (r+1)^3 cell-corner lattice.

    :param positions_b: (B,) flat voxel ids of the meshing batch.
    :param cube_sdf/std: (B, 2r, 2r, 2r).
    :return: sdf, std (B, r+1, r+1, r+1).
    """
    B = cube_sdf.shape[0]
    S = (2 * r) ** 3
    dev = cube_sdf.device
    off, flat, w = (torch.as_tensor(a, device=dev) for a in _corner_blend_mats(r))
    vox_xyz = vox.unlinearize_id(positions_b, n_xyz)                     # (B, 3)
    src = vox_xyz[:, None, :] + torch.as_tensor(_OFFSETS27, device=dev)[None]
    inb = vox.in_bounds(src, n_xyz)                                       # (B, 27)
    slot = indexer[vox.linearize_id(vox.clamp_grid(src, n_xyz), n_xyz)].long()
    row = batch_map[slot.clamp(0, latent_capacity - 1)].long()
    ok = inb & (slot >= 0) & (row >= 0)
    # std-weighted numerator (sdf * std) and the std planes, one gather each
    planes = torch.stack([(cube_sdf * cube_std).reshape(B * S),
                          cube_std.reshape(B * S)], dim=-1)               # (B*S, 2)
    row_k = row.clamp(0, B - 1)[:, off]                                   # (B, 8, P)
    wk = w[None] * ok[:, off].to(torch.float32)                           # (B, 8, P)
    g = planes[row_k * S + flat[None]]                                    # (B, 8, P, 2)
    num_sdf = torch.sum(g[..., 0] * wk, dim=1)
    den_sdf = torch.sum(g[..., 1] * wk, dim=1)
    den_std = torch.sum(wk, dim=1)
    sdf = num_sdf / torch.clamp_min(den_sdf, 1e-12)
    std = den_sdf / torch.clamp_min(den_std, 1e-12)
    shape = (B, r + 1, r + 1, r + 1)
    return sdf.reshape(shape), std.reshape(shape)


def marching_cubes_sparse(indexer, batch_map, positions_b, batch_valid,
                          cube_sdf, cube_std, n_xyz, voxel_size, bound_min,
                          r: int, latent_capacity: int, max_std: float,
                          budget: int, frontier_kill: bool = True) -> MCResult:
    """Extract triangles for a batch of voxels.

    :param indexer: (n_voxels,) flat id -> slot.
    :param batch_map: (C,) slot -> batch row | -1.
    :param positions_b: (B,) flat voxel ids of the meshing batch.
    :param batch_valid: (B,) bool (padding rows off).
    :param cube_sdf/cube_std: (B, 2r, 2r, 2r) decoder samples.
    :param budget: max triangles returned.
    """
    dev = cube_sdf.device
    B = cube_sdf.shape[0]
    positions_b = positions_b.long()
    if frontier_kill:
        own_slot = indexer[positions_b].long()
        own_row = batch_map[own_slot.clamp(0, latent_capacity - 1)]
        own_ok = (own_slot >= 0) & (own_slot < latent_capacity) & (own_row >= 0)
        batch_valid = batch_valid & own_ok
    sdf, std = _corner_field(indexer, batch_map, positions_b, cube_sdf, cube_std,
                             n_xyz, r, latent_capacity)

    # Cells: r^3 per voxel; corner c of cell (x, y, z) is (x, y, z) + CORNERS[c].
    cr = np.arange(r)
    cx, cy, cz = np.meshgrid(cr, cr, cr, indexing="ij")
    cell_np = np.stack([cx, cy, cz], -1).reshape(-1, 3)
    Q = cell_np.shape[0]
    cidx = cell_np[:, None, :] + CORNERS.astype(np.int64)[None]           # (Q, 8, 3)
    cflat = torch.as_tensor(((cidx[..., 0] * (r + 1) + cidx[..., 1]) * (r + 1)
                             + cidx[..., 2]).reshape(-1), device=dev)
    c_sdf = sdf.reshape(B, -1)[:, cflat].reshape(B, Q, 8)
    c_std = std.reshape(B, -1)[:, cflat].reshape(B, Q, 8)
    bits = (2 ** torch.arange(8, device=dev))
    config = torch.sum((c_sdf < 0).long() * bits, dim=-1)                 # (B, Q)

    # Compact the active cells (config not 0/255) before any edge work.
    T = MAX_TRIS_PER_CELL
    NC = min(B * Q, max(4096, B * 4 * r))
    flat_active = (batch_valid[:, None] & (config > 0) & (config < 255)).reshape(-1)
    cell_idx, cell_ok, _ = vox.compact_by_mask(
        torch.arange(B * Q, device=dev), flat_active, NC)
    cells_dropped = flat_active.sum() > NC
    cs = c_sdf.reshape(B * Q, 8)[cell_idx]                                 # (NC, 8)
    ss = c_std.reshape(B * Q, 8)[cell_idx]
    cfg_c = config.reshape(-1)[cell_idx]
    fid_c = positions_b[cell_idx // Q]

    # Vertex on each of the 12 edges (sdf-weighted lerp).
    ec = torch.as_tensor(EDGE_CORNERS, device=dev)
    v1, v2 = cs[:, ec[:, 0]], cs[:, ec[:, 1]]                              # (NC, 12)
    s1, s2 = ss[:, ec[:, 0]], ss[:, ec[:, 1]]
    denom = v2 - v1
    t = torch.where(torch.abs(denom) < 1e-5, torch.zeros_like(v1),
                    -v1 / torch.where(denom == 0, torch.ones_like(denom), denom))
    t = torch.where(torch.abs(v1) < 1e-5, torch.zeros_like(t),
                    torch.where(torch.abs(v2) < 1e-5, torch.ones_like(t), t))
    t = torch.clamp(t, 0.0, 1.0)
    p1 = torch.as_tensor(CORNERS[EDGE_CORNERS[:, 0]], dtype=torch.float32, device=dev)
    p2 = torch.as_tensor(CORNERS[EDGE_CORNERS[:, 1]], dtype=torch.float32, device=dev)
    edge_pos = p1[None] + t[..., None] * (p2 - p1)[None]                    # (NC, 12, 3)
    es = s1 + t * (s2 - s1)                                                 # (NC, 12)

    vox_xyz = vox.unlinearize_id(fid_c, n_xyz).to(torch.float32)
    cell = torch.as_tensor(cell_np, device=dev)
    cell_origin = vox_xyz + cell[cell_idx % Q].to(torch.float32) / r
    bmin = torch.as_tensor(bound_min, dtype=torch.float32, device=dev)
    ew = (cell_origin[:, None, :] + edge_pos / r) * voxel_size + bmin[None, None, :]

    # Triangle table lookup: edges of each triangle corner, -1 = none.
    tri = torch.as_tensor(TRI_TABLE[:, :3 * T], device=dev)[cfg_c]         # (NC, 3T)
    tri = tri.reshape(-1, T, 3)
    tri_ok = tri[..., 0] >= 0                                               # (NC, T)
    e_idx = tri.clamp_min(0)
    nidx = torch.arange(tri.shape[0], device=dev)[:, None, None]
    verts = ew[nidx, e_idx]                                                 # (NC, T, 3, 3)
    vstd = es[nidx, e_idx]                                                  # (NC, T, 3)
    tri_valid = tri_ok & cell_ok[:, None] & (torch.amax(vstd, dim=-1) <= max_std)

    # Prefix-sum compaction into the fixed budget, sentinel row for the rest.
    flat_valid = tri_valid.reshape(-1)
    n_tri = flat_valid.sum()
    rank = torch.cumsum(flat_valid, 0) - 1
    keep = flat_valid & (rank < budget)
    dest = torch.where(keep, rank, budget)
    out_verts = torch.zeros((budget + 1, 3, 3), dtype=torch.float32, device=dev)
    out_verts.index_copy_(0, dest, verts.reshape(-1, 3, 3))
    out_std = torch.zeros((budget + 1, 3), dtype=torch.float32, device=dev)
    out_std.index_copy_(0, dest, vstd.reshape(-1, 3))
    out_fid = torch.full((budget + 1,), -1, dtype=torch.int64, device=dev)
    out_fid.index_copy_(0, dest, fid_c[:, None].expand(-1, T).reshape(-1))
    valid = torch.arange(budget, device=dev) < n_tri
    return MCResult(out_verts[:budget], out_std[:budget], out_fid[:budget],
                    valid, n_tri, cells_dropped)
