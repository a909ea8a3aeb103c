"""Sparse latent voxel map as fixed-capacity tensors.

Counterpart of the JAX package's ``system/map.py``: a dense ``indexer``
(flat voxel id -> latent slot, -1 empty) plus per-slot latents, positions,
observation counts; fixed capacities with an overflow flag instead of
reallocation.  ``integrate_keyframe`` prunes sparse observations,
allocates unseen voxels with 6-neighbour dummies, runs the encoder kernel
over the x8 corner pairs and fuses by a running mean; ``get_sdf`` runs the
decoder kernel (with its input gradient when the query needs one).  The
state tensors keep the JAX dtypes, so ``map.npz`` files interchange.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops import voxel as vox


class MapConfig(NamedTuple):
    """Map geometry + fusion thresholds."""
    n_xyz: tuple                 # (Nx, Ny, Nz)
    voxel_size: float
    bound_min: tuple             # (3,)
    prune_min_vox_obs: int       # drop voxels observed by fewer points
    ignore_count_th: float       # min obs count for SDF queries / meshing
    encoder_count_th: float      # stop encoder updates above this confidence
    latent_dim: int
    latent_capacity: int         # max allocated voxels (C)
    alloc_capacity: int          # max new voxels per integrate call

    @property
    def n_voxels(self):
        return int(np.prod(self.n_xyz))

    @staticmethod
    def from_args(args, latent_dim: int) -> "MapConfig":
        n_xyz = tuple(int(x) for x in np.ceil(
            (np.asarray(args.bound_max) - np.asarray(args.bound_min)) / args.voxel_size))
        return MapConfig(
            n_xyz=n_xyz,
            voxel_size=float(args.voxel_size),
            bound_min=tuple(float(x) for x in args.bound_min),
            prune_min_vox_obs=int(args.prune_min_vox_obs),
            ignore_count_th=float(args.ignore_count_th),
            encoder_count_th=float(args.encoder_count_th),
            latent_dim=latent_dim,
            latent_capacity=int(getattr(args, "latent_capacity", 40960)),
            alloc_capacity=int(getattr(args, "alloc_capacity", 8192)),
        )


class MapState(NamedTuple):
    indexer: torch.Tensor      # (n_voxels,) int32: flat voxel id -> slot | -1
    latents: torch.Tensor      # (C, L) f32
    positions: torch.Tensor    # (C,) int32: slot -> flat voxel id | -1
    obs_count: torch.Tensor    # (C,) f32
    optimized: torch.Tensor    # (C,) bool
    n_occupied: torch.Tensor   # () int32
    overflow: torch.Tensor     # () bool


def init_state(cfg: MapConfig, device) -> MapState:
    C = cfg.latent_capacity
    return MapState(
        indexer=torch.full((cfg.n_voxels,), -1, dtype=torch.int32, device=device),
        latents=torch.zeros((C, cfg.latent_dim), dtype=torch.float32, device=device),
        positions=torch.full((C,), -1, dtype=torch.int32, device=device),
        obs_count=torch.zeros((C,), dtype=torch.float32, device=device),
        optimized=torch.zeros((C,), dtype=torch.bool, device=device),
        n_occupied=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


# Every surface point contributes to the voxel containing it under each of
# the 8 half-voxel shifts.
_CORNER_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-0.5, 0.5) for dy in (-0.5, 0.5) for dz in (-0.5, 0.5)],
    dtype=np.float32)


def _allocate(state: MapState, cfg: MapConfig, gid: torch.Tensor,
              valid: torch.Tensor) -> MapState:
    """Allocate slots for unseen voxels among ``gid`` plus 6-neighbour dummies."""
    indexer = state.indexer.long()
    unseen = valid & (indexer[gid.clamp(0, cfg.n_voxels - 1)] == -1)
    uniq, uniq_valid, _, ovf1 = vox.masked_unique(gid, unseen, cfg.alloc_capacity)
    exp_ids, exp_valid = vox.expand_neighbors6(uniq, uniq_valid, cfg.n_xyz)
    cand, cand_valid, _, ovf2 = vox.masked_unique(exp_ids, exp_valid,
                                                  7 * cfg.alloc_capacity)
    new = cand_valid & (indexer[cand] == -1)
    rank = torch.cumsum(new, 0) - 1
    n_new = new.sum()
    slot = state.n_occupied.long() + rank
    fits = new & (slot < cfg.latent_capacity)
    C, V = cfg.latent_capacity, cfg.n_voxels
    idx_new = torch.cat([state.indexer, state.indexer.new_full((1,), -1)])
    idx_new.index_copy_(0, torch.where(fits, cand, V),
                        torch.where(fits, slot, -1).to(torch.int32))
    pos_new = torch.cat([state.positions, state.positions.new_full((1,), -1)])
    pos_new.index_copy_(0, torch.where(fits, slot, C), cand.to(torch.int32))
    n_occ = torch.clamp_max(state.n_occupied.long() + n_new, C).to(torch.int32)
    overflow = state.overflow | ovf1 | ovf2 | (state.n_occupied.long() + n_new > C)
    return state._replace(indexer=idx_new[:V], positions=pos_new[:C],
                          n_occupied=n_occ, overflow=overflow)


def integrate_keyframe(state: MapState, cfg: MapConfig, encoder,
                       points: torch.Tensor, normals: torch.Tensor,
                       valid: torch.Tensor, pose_R: torch.Tensor = None,
                       pose_t: torch.Tensor = None):
    """Fuse one oriented point cloud into the latent map.

    :param points/normals: (N, 3), camera frame when a pose is given.
    :param valid: (N,) bool padding mask.
    :return: (new_state, updated (C,) bool: the slots this frame changed)
    """
    if pose_R is not None:
        points = points @ pose_R.T + pose_t[None, :]
        normals = normals @ pose_R.T
    dev = points.device
    bound_min = torch.as_tensor(cfg.bound_min, dtype=torch.float32, device=dev)
    xyz_norm, grid = vox.world_to_grid(points, bound_min, cfg.voxel_size)
    valid = valid & vox.in_bounds(grid, cfg.n_xyz)
    gid = vox.linearize_id(vox.clamp_grid(grid, cfg.n_xyz), cfg.n_xyz)

    # 1. Prune sparse observations (unique-count threshold).
    if cfg.prune_min_vox_obs > 0:
        valid = valid & (vox.occurrence_count(gid, valid) > cfg.prune_min_vox_obs)

    # 2. Allocate unseen voxels (+ dummy neighbours).
    state = _allocate(state, cfg, gid, valid)
    indexer = state.indexer.long()

    # 3. Encoder-eligible voxels: allocated and below the confidence cap.
    enc_slot_mask = (state.positions >= 0) & (state.obs_count < cfg.encoder_count_th)
    # A point takes part only if its own voxel lies in the 6-neighbour
    # expansion of the encoder voxel set.
    enc_pos = torch.where(enc_slot_mask, state.positions.long(), 0)
    exp_ids, exp_valid = vox.expand_neighbors6(enc_pos, enc_slot_mask, cfg.n_xyz)
    focus_grid = torch.zeros(cfg.n_voxels + 1, dtype=torch.bool, device=dev)
    focus_grid[torch.where(exp_valid, exp_ids, cfg.n_voxels)] = True
    point_focus = valid & focus_grid[:cfg.n_voxels][gid]

    # 4. x8 corner gather: each point to its 8 shifted voxels.
    offs = torch.as_tensor(_CORNER_OFFSETS, device=dev)                  # (8, 3)
    tgt = torch.ceil(xyz_norm[:, None, :] + offs[None]).long() - 1
    tgt = vox.clamp_grid(tgt, cfg.n_xyz)                                  # (N, 8, 3)
    rel = xyz_norm[:, None, :] - tgt.to(torch.float32) - 0.5
    tgt_slot = indexer[vox.linearize_id(tgt, cfg.n_xyz)]                  # (N, 8)
    pair_ok = point_focus[:, None] & (tgt_slot >= 0)
    feats = torch.cat([rel, normals[:, None, :].expand_as(rel)], dim=-1).reshape(-1, 6)

    # 5. Shared-MLP encoder over all (point, corner) pairs: the kernel.
    enc_latent = encoder(feats)

    # 6. Running-mean fusion through one (L+1)-channel segment-sum.
    C = cfg.latent_capacity
    seg = tgt_slot.reshape(-1).clamp(0, C - 1)
    packed = torch.cat([enc_latent, torch.ones_like(enc_latent[:, :1])], dim=1)
    red = vox.masked_segment_sum(packed, seg, pair_ok.reshape(-1), C)
    lat_sum = torch.where(enc_slot_mask[:, None], red[:, :-1], 0.0)
    cnt = torch.where(enc_slot_mask, red[:, -1], 0.0)
    new_total = state.obs_count + cnt
    fused = (lat_sum + state.latents * state.obs_count[:, None]) \
        / torch.clamp_min(new_total, 1.0)[:, None]
    updated = cnt > 0
    latents = torch.where(updated[:, None], fused, state.latents)
    return state._replace(latents=latents, obs_count=new_total), updated


def get_sdf(state: MapState, cfg: MapConfig, decoder, xyz: torch.Tensor):
    """Decode the SDF at world points: (sdf (N,), std (N,), valid (N,)).

    Voxel lookup, obs-count gating, decoder on voxel-local coordinates.
    Invalid points still run through the decoder; callers mask.  When
    ``xyz`` requires grad, sdf is differentiable w.r.t. it (the kernel's
    forward-mode input gradient); the voxel lookup and the latent are not.
    """
    bound_min = torch.as_tensor(cfg.bound_min, dtype=torch.float32, device=xyz.device)
    xyz_norm = (xyz - bound_min[None, :]) / cfg.voxel_size
    grid = torch.ceil(xyz_norm.detach()).long() - 1
    inb = vox.in_bounds(grid, cfg.n_xyz)
    gid = vox.linearize_id(vox.clamp_grid(grid, cfg.n_xyz), cfg.n_xyz)
    slot = state.indexer.long()[gid]
    slot_c = slot.clamp(0, cfg.latent_capacity - 1)
    valid = inb & (slot >= 0) & (state.obs_count[slot_c] > cfg.ignore_count_th)
    latent = state.latents[slot_c]
    rel = xyz_norm - grid.to(torch.float32) - 0.5
    if rel.requires_grad:
        sdf, std = decoder.sdf_with_grad(latent, rel)
    else:
        sdf, std = decoder(torch.cat([latent, rel], dim=1))
        sdf, std = sdf[:, 0], std[:, 0]
    return sdf, std, valid


class SparseVoxelMap:
    """Host-side owner of the map state and the model.

    ``updated_slots`` (host) and ``_updated_dev`` (device) accumulate the
    slots touched since the last meshing; the mesher consumes them.
    """

    def __init__(self, model, args, latent_dim: int, device):
        self.model = model
        self.device = torch.device(device)
        self.cfg = MapConfig.from_args(args, latent_dim)
        self.state = init_state(self.cfg, self.device)
        self.updated_slots = np.zeros((self.cfg.latent_capacity,), bool)
        self._updated_dev = None
        logging.info("Map size Nx=%d Ny=%d Nz=%d (capacity %d voxels)",
                     *self.cfg.n_xyz, self.cfg.latent_capacity)

    def integrate_keyframe(self, points, normals, valid=None, pose=None):
        """Fuse a frame.  ``pose``: camera-to-world as an Isometry or a
        device (R, t); with it, points/normals may stay camera-frame."""
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        normals = torch.as_tensor(normals, dtype=torch.float32, device=self.device)
        if valid is None:
            valid = torch.ones(points.shape[0], dtype=torch.bool, device=self.device)
        pose_R = pose_t = None
        if pose is not None:
            if hasattr(pose, "q"):
                pose_R = torch.as_tensor(pose.q.rotation_matrix, dtype=torch.float32,
                                         device=self.device)
                pose_t = torch.as_tensor(pose.t, dtype=torch.float32, device=self.device)
            else:
                pose_R, pose_t = pose
        self.state, updated = integrate_keyframe(
            self.state, self.cfg, self.model.encoder, points, normals, valid,
            pose_R, pose_t)
        self._updated_dev = (updated if self._updated_dev is None
                             else self._updated_dev | updated)
        return updated

    # -- persistence: the JAX package's map.npz layout -----------------------
    def save(self, path):
        np.savez(Path(path), **{k: v.cpu().numpy() for k, v in self.state._asdict().items()})

    def load(self, path):
        path = Path(path)
        if not path.exists():
            path = path.with_suffix(".npz")
        with np.load(path) as d:
            self.state = MapState(**{k: torch.tensor(d[k], device=self.device)
                                     for k in MapState._fields})
