"""The latent voxel map in plain PyTorch: its SDF query and its integration.

The map is a dense ``indexer`` (flat voxel id -> slot, -1 empty) over a
grid of ``voxel_size`` boxes from ``bound_min``, and per slot a latent, the
voxel's flat id and an observation count.  A query decodes [latent, rel]
in the voxel holding the point (rel in [-0.5, 0.5]^3), valid where the
voxel exists and its count exceeds ``ignore_count_th``.

Integrating a frame's oriented points at a pose: points of voxels seen by
at most ``prune_min_vox_obs`` points are dropped; unseen voxels are
allocated in ascending id order with their 6 neighbours (at most
``alloc_capacity`` new ids a frame, ``latent_capacity`` slots in all).
Slots below ``encoder_count_th`` take part; a point takes part if its own
voxel lies within one axis step of such a slot.  Each point is encoded
with its normal in each of the 8 voxels around it (the voxel of the point
shifted by half a voxel along each axis), and each slot takes the running
mean of its old latent (weighted by its count) and the encodings it got.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .model import decode, decode_grad, encode
from .precision import F32, Precision

CORNERS = np.array([[dx, dy, dz] for dx in (-0.5, 0.5) for dy in (-0.5, 0.5)
                    for dz in (-0.5, 0.5)], np.float32)


def map_cfg_of(mapping: dict, latent_dim: int) -> dict:
    lo, hi = np.asarray(mapping["bound_min"]), np.asarray(mapping["bound_max"])
    n_xyz = tuple(int(x) for x in np.ceil((hi - lo) / mapping["voxel_size"]))
    return {"n_xyz": n_xyz, "n_voxels": int(np.prod(n_xyz)),
            "voxel_size": float(mapping["voxel_size"]),
            "bound_min": tuple(float(x) for x in lo),
            "prune_min_vox_obs": int(mapping["prune_min_vox_obs"]),
            "ignore_count_th": float(mapping["ignore_count_th"]),
            "encoder_count_th": float(mapping["encoder_count_th"]),
            "latent_capacity": int(mapping["latent_capacity"]),
            "alloc_capacity": int(mapping["alloc_capacity"]), "latent_dim": latent_dim}


def map_sdf(prior, state: dict, cfg: dict, xyz, with_grad: bool = False,
            prec: Precision = F32):
    """(sdf, std, valid[, d sdf / d rel]) at world points (N, 3)."""
    bmin = torch.as_tensor(cfg["bound_min"], dtype=torch.float32, device=xyz.device)
    xyz_norm = (xyz - bmin[None, :]) / cfg["voxel_size"]
    grid = torch.ceil(xyz_norm).long() - 1
    inb = G.in_bounds(grid, cfg["n_xyz"])
    gid = G.linearize(G.clamp_grid(grid, cfg["n_xyz"]), cfg["n_xyz"])
    slot = state["indexer"].long()[gid]
    slot_c = slot.clamp(0, cfg["latent_capacity"] - 1)
    valid = inb & (slot >= 0) & (state["obs_count"][slot_c] > cfg["ignore_count_th"])
    x = torch.cat([state["latents"][slot_c], xyz_norm - grid.to(torch.float32) - 0.5], 1)
    if with_grad:
        sdf, std, grad = decode_grad(prior, x, prec)
        return sdf, std, valid, grad
    sdf, std = decode(prior, x, prec)
    return sdf, std, valid


def _allocate(state, cfg, gid, valid):
    indexer = state["indexer"].long()
    V, C = cfg["n_voxels"], cfg["latent_capacity"]
    unseen = valid & (indexer[gid.clamp(0, V - 1)] == -1)
    uniq, uvalid, ovf1 = G.masked_unique(gid, unseen, cfg["alloc_capacity"])
    exp_ids, exp_valid = G.expand6(uniq, uvalid, cfg["n_xyz"])
    cand, cvalid, ovf2 = G.masked_unique(exp_ids, exp_valid, 7 * cfg["alloc_capacity"])
    new = cvalid & (indexer[cand] == -1)
    slot = state["n_occupied"].long() + torch.cumsum(new, 0) - 1
    fits = new & (slot < C)
    idx = torch.cat([state["indexer"], state["indexer"].new_full((1,), -1)])
    idx.index_copy_(0, torch.where(fits, cand, V), torch.where(fits, slot, -1).to(torch.int32))
    pos = torch.cat([state["positions"], state["positions"].new_full((1,), -1)])
    pos.index_copy_(0, torch.where(fits, slot, C), cand.to(torch.int32))
    n_new = new.sum()
    out = dict(state)
    out.update(indexer=idx[:V], positions=pos[:C],
               n_occupied=torch.clamp_max(state["n_occupied"].long() + n_new, C).to(torch.int32),
               overflow=state["overflow"] | ovf1 | ovf2 | (state["n_occupied"].long() + n_new > C))
    return out


def integrate(prior, state: dict, cfg: dict, points, normals, valid, R, t,
              prec: Precision = F32) -> dict:
    """The map after fusing camera-frame ``points`` / ``normals`` (N, 3) with
    mask ``valid`` at the camera-to-world pose (R, t)."""
    points = G.transform(R, t, points, prec)
    normals = prec.mm(normals, R.T)
    dev = points.device
    n_xyz = cfg["n_xyz"]
    bmin = torch.as_tensor(cfg["bound_min"], dtype=torch.float32, device=dev)
    xyz_norm = (points - bmin[None, :]) / cfg["voxel_size"]
    grid = torch.ceil(xyz_norm).long() - 1
    valid = valid & G.in_bounds(grid, n_xyz)
    gid = G.linearize(G.clamp_grid(grid, n_xyz), n_xyz)
    if cfg["prune_min_vox_obs"] > 0:
        valid = valid & (G.occurrence_count(gid, valid) > cfg["prune_min_vox_obs"])
    state = _allocate(state, cfg, gid, valid)
    indexer = state["indexer"].long()
    enc_slot = (state["positions"] >= 0) & (state["obs_count"] < cfg["encoder_count_th"])
    exp_ids, exp_valid = G.expand6(torch.where(enc_slot, state["positions"].long(), 0),
                                   enc_slot, n_xyz)
    focus = torch.zeros(cfg["n_voxels"] + 1, dtype=torch.bool, device=dev)
    focus[torch.where(exp_valid, exp_ids, cfg["n_voxels"])] = True
    point_focus = valid & focus[:cfg["n_voxels"]][gid]
    offs = torch.as_tensor(CORNERS, device=dev)
    tgt = G.clamp_grid(torch.ceil(xyz_norm[:, None, :] + offs[None]).long() - 1, n_xyz)
    rel = xyz_norm[:, None, :] - tgt.to(torch.float32) - 0.5
    tgt_slot = indexer[G.linearize(tgt, n_xyz)]
    pair_ok = point_focus[:, None] & (tgt_slot >= 0)
    feats = torch.cat([rel, normals[:, None, :].expand_as(rel)], -1).reshape(-1, 6)
    latent = encode(prior, feats, prec)
    C = cfg["latent_capacity"]
    seg = torch.where(pair_ok.reshape(-1), tgt_slot.reshape(-1).clamp(0, C - 1), C)
    red = torch.zeros((C + 1, latent.shape[1] + 1), dtype=torch.float32, device=dev)
    red.index_add_(0, seg, torch.cat([latent, torch.ones_like(latent[:, :1])], 1))
    red = red[:C]
    lat_sum = torch.where(enc_slot[:, None], red[:, :-1], 0.0)
    cnt = torch.where(enc_slot, red[:, -1], 0.0)
    total = state["obs_count"] + cnt
    fused = (lat_sum + state["latents"] * state["obs_count"][:, None]) \
        / torch.clamp_min(total, 1.0)[:, None]
    out = dict(state)
    out.update(latents=torch.where((cnt > 0)[:, None], fused, state["latents"]),
               obs_count=total, updated=cnt > 0)
    return out
