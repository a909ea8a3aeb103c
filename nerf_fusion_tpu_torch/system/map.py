"""Sparse latent voxel map as fixed-capacity tensors.

Counterpart of the JAX package's ``system/map.py``: a dense ``indexer``
(flat voxel id -> latent slot, -1 empty) plus per-slot latents, positions,
observation counts; fixed capacities with an overflow flag instead of
reallocation.  ``integrate_keyframe`` prunes sparse observations,
allocates unseen voxels with 6-neighbour dummies, runs the encoder kernel
over the x8 corner pairs and fuses by a running mean; ``get_sdf`` runs the
decoder kernel (with its input gradient when the query needs one).  The
state tensors keep the JAX dtypes, so ``map.npz`` files interchange.
``SparseVoxelMap.integrate_keyframe(do_optimize=True)`` refines the
latents after fusing (``system.refine``), in place or on a worker.
``get_fast_preview_visuals`` and ``get_map_visuals`` give the map's debug
visuals as the numpy payloads of ``utils.vis`` (voxel blocks, decoded
sample and uncertainty clouds, a mesh of the whole map).
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops import voxel as vox
from .worker import Worker


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


def get_sdf(state: MapState, cfg: MapConfig, decoder, xyz: torch.Tensor,
            bound_min: torch.Tensor = None, with_grad: bool = False):
    """Decode the SDF at world points: (sdf (N,), std (N,), valid (N,)), and
    with ``with_grad`` also d sdf / d rel (N, 3), the kernel's forward-mode
    gradient in the voxel-local coordinates rel = (xyz - bound_min) /
    voxel_size - cell (the voxel lookup and the latent are constants).

    Voxel lookup, obs-count gating, decoder on voxel-local coordinates.
    Invalid points still run through the decoder; callers mask.
    ``bound_min``: ``cfg.bound_min`` as a (3,) tensor on ``xyz``'s device
    (``SparseVoxelMap.bound_min``); built here if None, which is a
    host-to-device copy and so cannot be captured in a CUDA graph.
    """
    if bound_min is None:
        bound_min = torch.as_tensor(cfg.bound_min, dtype=torch.float32, device=xyz.device)
    x, valid = vox.decoder_rows(xyz, bound_min, cfg.voxel_size, cfg.n_xyz, state.indexer,
                                state.obs_count, state.latents, cfg.ignore_count_th)
    if with_grad:
        out, grad = decoder.forward_grad(x)
        return out[:, 0], out[:, 1], valid, grad
    sdf, std = decoder(x)
    return sdf[:, 0], std[:, 0], valid


class SparseVoxelMap:
    """Host-side owner of the map state and the model.

    ``updated_slots`` (host) and ``_updated_dev`` (device) accumulate the
    slots touched since the last meshing; the mesher consumes them, and
    ``_upd_lock`` guards them (the async mesher takes them and feeds its
    leftovers back from its thread).  The state's tensors keep their
    storage for the map's life: integrating, refining and loading copy into
    them, so a CUDA graph captured on them (the tracker's) reads the current
    map.  ``bound_min`` is ``cfg.bound_min`` on the device.  Refinement
    reads ``optim_n_iters`` (10) and ``code_reg_lambda`` (1e-2) from the
    mapping args and draws its jitter from a generator seeded with the
    mapping's ``seed`` + 1234; ``refine_log`` holds one entry a refinement.
    ``mesher``: the live mesher of the fusion loop, which the pipeline
    attaches (``get_map_visuals`` joins its async extraction first).
    """

    def __init__(self, model, args, latent_dim: int, device):
        self.model = model
        self.device = torch.device(device)
        self.cfg = MapConfig.from_args(args, latent_dim)
        self.state = init_state(self.cfg, self.device)
        self.bound_min = torch.as_tensor(self.cfg.bound_min, dtype=torch.float32,
                                         device=self.device)
        self.updated_slots = np.zeros((self.cfg.latent_capacity,), bool)
        self._updated_dev = None
        self._upd_lock = threading.Lock()
        self.refiner = None
        self._worker = None
        self._refine_gen = torch.Generator(device=self.device).manual_seed(
            int(getattr(args, "seed", 0)) + 1234)
        self.optim_n_iters = int(getattr(args, "optim_n_iters", 10))
        self.code_reg_lambda = float(getattr(args, "code_reg_lambda", 1e-2))
        self.refine_log = []
        self.refine_merged = 0          # async results merged
        self.mesher = None
        logging.info("Map size Nx=%d Ny=%d Nz=%d (capacity %d voxels)",
                     *self.cfg.n_xyz, self.cfg.latent_capacity)

    @property
    def worker(self) -> Worker:
        """The background worker of this map's async mesher and refiner
        (one thread, one CUDA stream), made at first use."""
        if self._worker is None:
            self._worker = Worker(self.device)
        return self._worker

    def _mark_updated(self, mask: torch.Tensor):
        with self._upd_lock:
            self._updated_dev = mask if self._updated_dev is None else self._updated_dev | mask

    @property
    def bound_max(self) -> np.ndarray:
        """The map's upper corner on the host (float64; ``bound_min`` is the
        lower one as a device tensor)."""
        return np.asarray(self.cfg.bound_min) + np.asarray(self.cfg.n_xyz) * self.cfg.voxel_size

    def integrate_keyframe(self, points, normals, valid=None, pose=None,
                           do_optimize: bool = False, async_optimize: bool = False):
        """Fuse a frame.  ``pose``: camera-to-world as an Isometry or a
        device (R, t); with it, points/normals may stay camera-frame.

        A finished async refinement is merged first (the de-integration
        merge).  With ``do_optimize`` the latents are refined after fusing
        against this frame's points in the world frame: in place, or with
        ``async_optimize`` dispatched to the worker unless it is busy.
        Refined voxels are marked updated, for the mesher."""
        from .refine import AsyncRefiner, StageClock, draw_jitter, merge_refined, \
            refine_latents

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
        self._merge_async()
        state, updated = integrate_keyframe(
            self.state, self.cfg, self.model.encoder, points, normals, valid,
            pose_R, pose_t)
        self._assign(state)
        self._mark_updated(updated)
        if do_optimize and self.optim_n_iters > 0:
            if async_optimize:
                if self.refiner is None:
                    self.refiner = AsyncRefiner(self.worker)
                if self.refiner.busy():
                    return updated
                self._merge_async()         # one that ended since the merge above
            if pose_R is not None:
                points = points @ pose_R.T + pose_t[None, :]
                normals = normals @ pose_R.T
            kw = dict(n_iters=self.optim_n_iters, code_reg_lambda=self.code_reg_lambda)
            log = {"async": bool(async_optimize)}
            self.refine_log.append(log)
            if async_optimize:
                gt = draw_jitter(points.shape[0], self._refine_gen, self.device)
                self.refiner.dispatch(self.state, self.cfg, self.model.decoder, points,
                                      normals, valid, gt, log=log, **kw)
            else:
                clock = log["clock"] = StageClock(self.device)
                clock.start()
                res = refine_latents(self.state, self.cfg, self.model.decoder, points,
                                     normals, valid, self._refine_gen, log=log, **kw)
                clock.stop()
                self._assign(merge_refined(self.state, res, deintegrate=False))
                self._mark_updated(res.refined)
        return updated

    def _merge_async(self):
        """Merge a finished async refinement (the de-integration merge)."""
        from .refine import merge_refined

        res = None if self.refiner is None else self.refiner.collect()
        if res is not None:
            self._assign(merge_refined(self.state, res, deintegrate=True))
            self._mark_updated(res.refined)
            self.refine_merged += 1

    def join_refiner(self):
        """Wait for a running async refinement and merge it."""
        if self.refiner is not None:
            self.refiner.join()
            self._merge_async()

    def refine_summary(self) -> list:
        """Host values of ``refine_log`` (syncs): per refinement its mode,
        eligible and sampled voxels, ms and the mean NLL at the first and
        last Adam step; a job still running is left out."""
        out = []
        for e in self.refine_log:
            if "nll" not in e:
                continue
            nll = e["nll"].tolist()
            out.append({"async": e["async"], "eligible": int(e["eligible"]),
                        "sampled": int(e["sampled"]), "ms": e["clock"].ms(),
                        "nll_first": nll[0] if nll else None,
                        "nll_last": nll[-1] if nll else None})
        return out

    def get_sdf(self, xyz, with_grad: bool = False):
        """``get_sdf`` on the map's state at world points ``xyz`` (N, 3)."""
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=self.device)
        return get_sdf(self.state, self.cfg, self.model.decoder, xyz, self.bound_min,
                       with_grad=with_grad)

    def sync_updated(self):
        """Fold the device-side updated-voxel accumulator into the host set
        (one copy to the host)."""
        with self._upd_lock:
            upd, self._updated_dev = self._updated_dev, None
            if upd is not None:
                self.updated_slots |= upd.cpu().numpy()
            return self.updated_slots

    def check_overflow(self):
        """Raise if an integration found the map's capacities too small."""
        if bool(self.state.overflow):
            raise RuntimeError(
                "Map capacity overflow: raise mapping.latent_capacity/alloc_capacity")

    # -- persistence: the JAX package's map.npz layout -----------------------
    def save(self, path):
        np.savez(Path(path), **{k: v.cpu().numpy() for k, v in self.state._asdict().items()})

    def load(self, path):
        path = Path(path)
        if not path.exists():
            path = path.with_suffix(".npz")
        with np.load(path) as d:
            self._assign(MapState(**{k: torch.from_numpy(d[k]) for k in MapState._fields}))

    def _assign(self, state: MapState):
        """Copy ``state`` into the map's tensors, field by field."""
        for name, old, new in zip(MapState._fields, self.state, state):
            if old.shape != new.shape or old.dtype != new.dtype:
                raise ValueError(f"map state {name}: {tuple(new.shape)} {new.dtype} does "
                                 f"not fit the map's {tuple(old.shape)} {old.dtype}")
            old.copy_(new)

    # -- debug visuals (numpy payloads of utils.vis) -------------------------
    def _voxel_xyz(self, flat_ids: np.ndarray) -> np.ndarray:
        """Grid coordinates (int64) of flat voxel ids, on the host."""
        _, ny, nz = self.cfg.n_xyz
        flat_ids = flat_ids.astype(np.int64)
        return np.stack([flat_ids // (ny * nz), (flat_ids // nz) % ny, flat_ids % nz], -1)

    def get_fast_preview_visuals(self):
        """Wireframes of all allocated voxel blocks and of the map's bound,
        as one merged line set."""
        from ..utils import vis

        occupied = self.state.positions.cpu().numpy()
        bound_min = np.asarray(self.cfg.bound_min)
        start = self._voxel_xyz(occupied[occupied >= 0]) * self.cfg.voxel_size + bound_min
        boxes = [vis.wireframe_bbox(s, s + self.cfg.voxel_size) for s in start]
        boxes.append(vis.wireframe_bbox(bound_min, self.bound_max, color_id=4))
        return [vis.merged_linesets(boxes)]

    def decode_samples(self, voxel_resolution: int = 8):
        """The decoder on a (voxel_resolution)^3 lattice in each confident
        voxel (the mesher's sample lattice): (net_in (N, 32), sdf (N,),
        std (N,)) on the device and the samples' world positions (N, 3) on
        the host (float64), or None if no voxel is confident."""
        from .mesher import _sample_offsets

        st = self.state
        slots = torch.nonzero((st.positions >= 0)
                              & (st.obs_count > self.cfg.ignore_count_th))[:, 0]
        if len(slots) == 0:
            return None
        offs = _sample_offsets(voxel_resolution // 2)
        B, S = len(slots), len(offs)
        net_in = torch.cat([st.latents[slots].repeat_interleave(S, dim=0),
                            torch.as_tensor(offs, device=self.device).repeat(B, 1)], dim=1)
        sdf, std = self.model.decoder(net_in)
        base = self._voxel_xyz(st.positions[slots].cpu().numpy())
        pos = (np.repeat(base, S, axis=0) + np.tile(offs + 0.5, (B, 1))) \
            * self.cfg.voxel_size + np.asarray(self.cfg.bound_min)
        return net_in, sdf[:, 0], std[:, 0], pos

    def get_map_visuals(self, return_blocks=False, return_samples=False,
                        return_uncertainty=False, return_mesh=False,
                        sample_range=None, voxel_resolution: int = 8):
        """Debug visuals: {"blocks", "samples", "uncertainty", "mesh"}, each a
        list (empty unless asked for).  Samples and uncertainty are point
        clouds of ``decode_samples`` coloured by sdf and std over
        ``sample_range`` (the sdf's range by default); the mesh is a full
        extraction of the map by a mesher of its own, which leaves the live
        mesher's updated-voxel accumulators as they were."""
        from ..utils import vis
        from .mesher import Mesher

        out = {"blocks": [], "samples": [], "uncertainty": [], "mesh": []}
        if return_blocks:
            out["blocks"] = self.get_fast_preview_visuals()
        if return_mesh:
            if self.mesher is not None:
                self.mesher.join_async()
            # the no_cache extraction takes (clears) both accumulators:
            # snapshot them and OR them back (a plain restore could lose an
            # integration's update made meanwhile; |= only re-meshes more)
            with self._upd_lock:
                saved_slots = self.updated_slots.copy()
                saved_dev = self._updated_dev
            try:
                out["mesh"] = [Mesher(self).extract(voxel_resolution, no_cache=True)]
            finally:
                with self._upd_lock:
                    self.updated_slots |= saved_slots
                    if saved_dev is not None:
                        self._updated_dev = (saved_dev if self._updated_dev is None
                                             else self._updated_dev | saved_dev)
        if return_samples or return_uncertainty:
            dec = self.decode_samples(voxel_resolution)
            if dec is None:
                return out
            _, sdf, std, pos = dec
            sdf, std = sdf.cpu().numpy(), std.cpu().numpy()
            lo, hi = sample_range if sample_range is not None else (sdf.min(), sdf.max())
            if return_samples:
                t = np.clip((sdf - lo) / max(hi - lo, 1e-9), 0, 1)
                out["samples"] = [vis.pointcloud(pos, cfloat=t)]
            if return_uncertainty:
                t = np.clip((std - lo) / max(hi - lo, 1e-9), 0, 1)
                out["uncertainty"] = [vis.pointcloud(pos, cfloat=t)]
        return out
