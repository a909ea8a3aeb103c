"""Mesh extraction of a batch of voxels in plain PyTorch.

Each meshed voxel is decoded on a (2r)^3 lattice spanning half a voxel of
margin on each side (sample i along an axis at (i - r // 2) / r - 0.5 in
the voxel's frame).  The corners of its r^3 cells blend, per axis, the
samples of the voxel and of its lower or upper neighbour, each weighted by
its predicted std (a neighbour outside the batch drops out); a voxel absent
from the batch emits nothing.  Marching cubes on the blended corners: the
vertex on a cut edge at the sdf's linear zero crossing, triangles whose
vertex std exceeds ``max_std`` dropped, triangles listed cell by cell in
batch-row order, at most ``max(4096, 16 r B)`` active cells.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .mc_tables import CORNERS, EDGE_CORNERS, MAX_TRIS_PER_CELL, TRI_TABLE
from .model import decode
from .precision import F32, Precision

DECODE_ROWS = 1 << 18
OFFSETS27 = np.array([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                      for dz in (-1, 0, 1)], np.int64)


def sample_offsets(r: int) -> np.ndarray:
    ax = (np.arange(2 * r) - r // 2) / r - 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)


def blend_sources(r: int):
    """For each corner p of the (r+1)^3 lattice its 8 sources: neighbour
    offset index (into OFFSETS27), sample index and weight, each (8, P)."""
    rp = np.arange(r + 1)
    X, Y, Z = np.meshgrid(rp, rp, rp, indexing="ij")
    pos = np.stack([X, Y, Z], -1).reshape(-1, 3)
    lower = pos <= (r - 1) // 2
    rs, mid = r // 2, r / 2.0
    off_m, off_p = np.where(lower, -1, 0), np.where(lower, 0, 1)
    idx_m = np.where(lower, pos + r + rs, pos + rs)
    idx_p = np.where(lower, pos + rs, pos + rs - r)
    w_m = np.where(lower, mid - pos, mid + r - pos) / r
    w_p = np.where(lower, pos + mid, pos - mid) / r
    n = 2 * r
    offs, flats, ws = [], [], []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = (sx, sy, sz)
                off = np.stack([(off_p if s else off_m)[:, a] for a, s in enumerate(sel)], -1)
                idx = np.stack([(idx_p if s else idx_m)[:, a] for a, s in enumerate(sel)], -1)
                w = ((w_p if sx else w_m)[:, 0] * (w_p if sy else w_m)[:, 1]
                     * (w_p if sz else w_m)[:, 2])
                offs.append(((off[:, 0] + 1) * 3 + off[:, 1] + 1) * 3 + off[:, 2] + 1)
                flats.append((idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2])
                ws.append(w)
    return np.stack(offs), np.stack(flats), np.stack(ws).astype(np.float32)


def decode_batch(prior, latents, r: int, prec: Precision = F32):
    """(B, L) latents -> (sdf, std), each (B, 2r, 2r, 2r)."""
    offs = torch.as_tensor(sample_offsets(r), device=latents.device)
    S = offs.shape[0]
    B = latents.shape[0]
    sdf = torch.empty(B * S, dtype=torch.float32, device=latents.device)
    std = torch.empty_like(sdf)
    per = max(DECODE_ROWS // S, 1)
    for s in range(0, B, per):
        lat = latents[s:s + per]
        x = torch.cat([lat.repeat_interleave(S, 0), offs.repeat(lat.shape[0], 1)], 1)
        a, b = decode(prior, x, prec)
        sdf[s * S:s * S + x.shape[0]] = a
        std[s * S:s * S + x.shape[0]] = b
    shape = (B, 2 * r, 2 * r, 2 * r)
    return sdf.reshape(shape), std.reshape(shape)


def extract(prior, state: dict, cfg: dict, batch_ids, batch_keep, r: int, max_std: float,
            prec: Precision = F32):
    """Triangles of the batch ``batch_ids`` (B,) flat voxel ids, rows with
    ``batch_keep`` meshed: (vertices (T, 3, 3), flatten_id (T,))."""
    dev = state["latents"].device
    B = batch_ids.shape[0]
    C = cfg["latent_capacity"]
    n_xyz = cfg["n_xyz"]
    ids = batch_ids.long()
    indexer = state["indexer"].long()
    slot = indexer[ids.clamp(0, cfg["n_voxels"] - 1)]
    keep = batch_keep & (slot >= 0)
    batch_map = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
    batch_map.index_copy_(0, torch.where(keep, slot, C), torch.arange(B, device=dev))
    batch_map = batch_map[:C]
    sdf_k, std_k = decode_batch(prior, state["latents"][slot[keep]], r, prec)
    n = 2 * r
    cube_sdf = torch.ones((B, n, n, n), dtype=torch.float32, device=dev)
    cube_std = torch.full((B, n, n, n), 1e6, dtype=torch.float32, device=dev)
    cube_sdf[keep], cube_std[keep] = sdf_k, std_k

    # corner field
    S = n ** 3
    off, flat, w = (torch.as_tensor(a, device=dev) for a in blend_sources(r))
    src = G.unlinearize(ids, n_xyz)[:, None, :] + torch.as_tensor(OFFSETS27, device=dev)[None]
    inb = G.in_bounds(src, n_xyz)
    sslot = indexer[G.linearize(G.clamp_grid(src, n_xyz), n_xyz)]
    row = batch_map[sslot.clamp(0, C - 1)]
    ok = inb & (sslot >= 0) & (row >= 0)
    planes = torch.stack([(cube_sdf * cube_std).reshape(-1), cube_std.reshape(-1)], -1)
    wk = w[None] * ok[:, off].to(torch.float32)
    g = planes[row.clamp(0, B - 1)[:, off] * S + flat[None]]
    den = torch.sum(g[..., 1] * wk, 1)
    corner_sdf = torch.sum(g[..., 0] * wk, 1) / torch.clamp_min(den, 1e-12)
    corner_std = den / torch.clamp_min(torch.sum(wk, 1), 1e-12)

    # cells and their configurations
    own = batch_map[slot.clamp(0, C - 1)]
    valid = keep & (own >= 0)
    cr = np.arange(r)
    cx, cy, cz = np.meshgrid(cr, cr, cr, indexing="ij")
    cell_np = np.stack([cx, cy, cz], -1).reshape(-1, 3)
    Q = cell_np.shape[0]
    cidx = cell_np[:, None, :] + CORNERS.astype(np.int64)[None]
    cflat = torch.as_tensor(((cidx[..., 0] * (r + 1) + cidx[..., 1]) * (r + 1)
                             + cidx[..., 2]).reshape(-1), device=dev)
    c_sdf = corner_sdf[:, cflat].reshape(B, Q, 8)
    c_std = corner_std[:, cflat].reshape(B, Q, 8)
    config = torch.sum((c_sdf < 0).long() * (2 ** torch.arange(8, device=dev)), -1)
    active = (valid[:, None] & (config > 0) & (config < 255)).reshape(-1)
    cells = torch.nonzero(active)[:, 0][:min(B * Q, max(4096, B * 4 * r))]
    cs, ss = c_sdf.reshape(-1, 8)[cells], c_std.reshape(-1, 8)[cells]
    cfg_c = config.reshape(-1)[cells]
    fid = ids[cells // Q]

    # a vertex on each edge, then the table's triangles
    ec = torch.as_tensor(EDGE_CORNERS, device=dev)
    v1, v2 = cs[:, ec[:, 0]], cs[:, ec[:, 1]]
    s1, s2 = ss[:, ec[:, 0]], ss[:, ec[:, 1]]
    denom = v2 - v1
    t = torch.where(torch.abs(denom) < 1e-5, torch.zeros_like(v1),
                    -v1 / torch.where(denom == 0, torch.ones_like(denom), denom))
    t = torch.where(torch.abs(v1) < 1e-5, torch.zeros_like(t),
                    torch.where(torch.abs(v2) < 1e-5, torch.ones_like(t), t))
    t = torch.clamp(t, 0.0, 1.0)
    p1 = torch.as_tensor(CORNERS[EDGE_CORNERS[:, 0]], dtype=torch.float32, device=dev)
    p2 = torch.as_tensor(CORNERS[EDGE_CORNERS[:, 1]], dtype=torch.float32, device=dev)
    edge_pos = p1[None] + t[..., None] * (p2 - p1)[None]
    es = s1 + t * (s2 - s1)
    origin = G.unlinearize(fid, n_xyz).to(torch.float32) \
        + torch.as_tensor(cell_np, device=dev)[cells % Q].to(torch.float32) / r
    bmin = torch.as_tensor(cfg["bound_min"], dtype=torch.float32, device=dev)
    ew = (origin[:, None, :] + edge_pos / r) * cfg["voxel_size"] + bmin[None, None, :]
    T = MAX_TRIS_PER_CELL
    tri = torch.as_tensor(TRI_TABLE[:, :3 * T], device=dev)[cfg_c].reshape(-1, T, 3)
    e_idx = tri.clamp_min(0)
    nidx = torch.arange(tri.shape[0], device=dev)[:, None, None]
    verts, vstd = ew[nidx, e_idx], es[nidx, e_idx]
    ok_tri = (tri[..., 0] >= 0) & (torch.amax(vstd, -1) <= max_std)
    return verts[ok_tri], fid[:, None].expand(-1, T)[ok_tri]
