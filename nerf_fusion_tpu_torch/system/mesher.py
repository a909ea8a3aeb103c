"""Incremental mesh extraction from the latent voxel map (sync path).

Counterpart of the JAX package's ``system/mesher.py`` for the fusion loop:

  * ``fused_extract``: updated slots -> 6-neighbour expansion -> dedup ->
    confidence filter -> decoder sample grids (the decoder kernel, in
    512-voxel chunks; all-padding chunks are skipped) -> marching cubes.
    A batch that does not fit ``mesh_budget`` defers its remainder: the
    ``leftover`` slot mask feeds the next extraction.
  * ``Mesher``: the host triangle cache keyed by owning voxel (every voxel
    of a re-meshed batch drops its stale triangles), deferred fetches
    (``materialize=False``), the deferral drain of materialising
    extractions, the latent-reuse gate (``reuse_latent_eps``) and PLY
    export.

The decoder runs in f32 whatever ``mesh_decode_precision`` says.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..ops import voxel as voxops
from ..ops.marching_cubes import marching_cubes_sparse

MESH_CHUNK = 512


class MeshCache(NamedTuple):
    """The latent-reuse gate's state, updated in place by ``fused_extract``:
    each slot's latent at its last meshing (row C is a sentinel) and
    whether that snapshot exists."""
    lat: torch.Tensor           # (C + 1, L) f32
    valid: torch.Tensor         # (C + 1,) bool


class _Pending(NamedTuple):
    """A dispatched-but-unfetched extraction.  Fused entries carry device
    tensors; the full re-mesh carries host ``mesh_ids`` and None for the
    rest."""
    mesh_ids: object
    keep: object
    result: object
    map_ovf: object
    leftover: object = None
    n_leftover: object = None


def _sample_offsets(r: int) -> np.ndarray:
    """Decoder-frame coords of the (2r)^3 margin lattice: sample i along an
    axis sits at (i - r//2)/r - 0.5 in the voxel-local frame."""
    i = np.arange(2 * r)
    ax = (i - r // 2) / r - 0.5
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)


def decode_cubes(decoder, latents_b: torch.Tensor, r: int):
    """(B, L) voxel latents -> (B, 2r, 2r, 2r) sdf and std sample grids
    (full decode of every sample)."""
    B, L = latents_b.shape
    offs = torch.as_tensor(_sample_offsets(r), device=latents_b.device)
    n_hi = offs.shape[0]
    net_in = torch.cat([latents_b.repeat_interleave(n_hi, dim=0),
                        offs.repeat(B, 1)], dim=1)
    sdf, std = decoder(net_in)
    shape = (B, 2 * r, 2 * r, 2 * r)
    return sdf.reshape(shape), std.reshape(shape)


def fused_extract(state, updated_mask, cfg, decoder, r: int, mesh_budget: int,
                  tri_budget: int, max_std: float, mesh_cache: MeshCache = None,
                  reuse_eps: float = 0.0, reuse_counts: torch.Tensor = None):
    """One incremental extraction.

    ``mesh_cache`` (optional) gates the updated set: an updated voxel whose
    latent moved by at most ``reuse_eps`` (max-abs) since its last meshing
    is dropped before the 6-neighbour dilation.  The snapshot of every
    voxel this batch meshes is then refreshed in place (deferred voxels
    keep their old snapshot).  ``reuse_counts`` (optional, (2,) int64)
    gets the number of updated voxels the gate saw and skipped added in
    place.
    :return: (MCResult, mesh_ids (mesh_budget,), keep (mesh_budget,) bool,
              map_overflow (), leftover (C,) bool, n_leftover ()).
    """
    C = cfg.latent_capacity
    dev = state.latents.device
    positions = state.positions.long()
    indexer = state.indexer.long()
    upd = updated_mask & (positions >= 0)
    if mesh_cache is not None:
        delta = (state.latents - mesh_cache.lat[:C]).abs().amax(dim=-1)
        gated = upd & (~mesh_cache.valid[:C] | (delta > reuse_eps))
        if reuse_counts is not None:
            reuse_counts.add_(torch.stack([upd.sum(), (upd & ~gated).sum()]))
        upd = gated
    upd_ids, upd_valid, _ = voxops.compact_by_mask(positions, upd, mesh_budget)
    exp_ids, exp_valid = voxops.expand_neighbors6(upd_ids, upd_valid, cfg.n_xyz)
    uniq, uniq_valid, _, _ = voxops.masked_unique(exp_ids, exp_valid, mesh_budget)
    slots = indexer[uniq.clamp(0, cfg.n_voxels - 1)]
    slot_c = slots.clamp(0, C - 1)
    keep = uniq_valid & (slots >= 0) & (state.obs_count[slot_c] > cfg.ignore_count_th)
    # Front-compact the kept rows (stable) so trailing all-padding decode
    # chunks can be skipped.
    perm = torch.sort((~keep).to(torch.uint8), stable=True).indices
    uniq, keep, slot_c = uniq[perm], keep[perm], slot_c[perm]
    batch_map = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
    batch_map.index_copy_(0, torch.where(keep, slot_c, C),
                          torch.arange(mesh_budget, device=dev))
    batch_map = batch_map[:C]
    lat_b = torch.where(keep[:, None], state.latents[slot_c], 0.0)
    if mesh_cache is not None:
        dst = torch.where(keep, slot_c, C)
        mesh_cache.lat.index_copy_(0, dst, state.latents[slot_c])
        mesh_cache.valid.index_fill_(0, dst, True)

    # Deferral set: allocated, confident slots in the 6-neighbour dilation
    # of the updated set that this batch did not take.
    upd_grid = torch.zeros(cfg.n_voxels + 1, dtype=torch.bool, device=dev)
    upd_grid[torch.where(upd, positions, cfg.n_voxels)] = True
    upd_grid = upd_grid[:cfg.n_voxels]
    pos_xyz = voxops.unlinearize_id(positions.clamp_min(0), cfg.n_xyz)
    need = upd.clone()
    for d in ([-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]):
        nb = pos_xyz + torch.as_tensor(d, device=dev)[None]
        inb = voxops.in_bounds(nb, cfg.n_xyz)
        ngid = voxops.linearize_id(voxops.clamp_grid(nb, cfg.n_xyz), cfg.n_xyz)
        need |= inb & upd_grid[ngid]
    need &= (positions >= 0) & (state.obs_count > cfg.ignore_count_th)
    leftover = need & (batch_map < 0)
    n_leftover = leftover.sum()

    if mesh_budget % MESH_CHUNK:
        raise ValueError("mesh_budget must be a MESH_CHUNK multiple")
    n_keep = int(keep.sum())              # one host read: chunks to decode
    shape = (mesh_budget, 2 * r, 2 * r, 2 * r)
    # all-padding chunks: inert fill (positive sdf, huge std)
    cube_sdf = torch.ones(shape, dtype=torch.float32, device=dev)
    cube_std = torch.full(shape, 1e6, dtype=torch.float32, device=dev)
    for s in range(0, n_keep, MESH_CHUNK):
        csdf, cstd = decode_cubes(decoder, lat_b[s:s + MESH_CHUNK], r)
        cube_sdf[s:s + MESH_CHUNK] = csdf
        cube_std[s:s + MESH_CHUNK] = cstd

    result = marching_cubes_sparse(
        indexer, batch_map, uniq, keep, cube_sdf, cube_std, cfg.n_xyz,
        cfg.voxel_size, cfg.bound_min, r, C, max_std, tri_budget)
    return result, uniq, keep, state.overflow, leftover, n_leftover


class Mesher:
    """Owns the incremental triangle cache for one map (sync mode)."""

    def __init__(self, vmap, max_n_triangles: int = 1 << 17,
                 mesh_batch_budget: int = 4096, reuse_latent_eps: float = 0.0):
        self.map = vmap
        self.budget = int(max_n_triangles)
        self.vertices = np.zeros((0, 3, 3), np.float32)
        self.vertices_std = np.zeros((0, 3), np.float32)
        self.vertices_flatten_id = np.zeros((0,), np.int64)
        self._pending = []
        self.mesh_budget = -(-int(mesh_batch_budget) // MESH_CHUNK) * MESH_CHUNK
        self.fused_tri_budget = min(self.budget, max(1 << 15, self.mesh_budget * 64))
        self._need_full_remesh = False
        # Latent-reuse gate (0 disables): the snapshot is keyed by the
        # extraction parameters that shape triangles, (r, max_std).
        self.reuse_latent_eps = float(reuse_latent_eps)
        self._mesh_cache = None
        self._mesh_cache_key = None
        self._reuse_counts = torch.zeros(2, dtype=torch.int64, device=vmap.device)

    def reuse_stats(self) -> dict:
        """Updated voxels the gate saw and skipped over the whole run."""
        n_upd, n_skip = self._reuse_counts.tolist()
        return {"updated": n_upd, "skipped": n_skip}

    def extract(self, voxel_resolution: int, max_std: float = 2000.0,
                no_cache: bool = False, materialize: bool = True):
        """Re-mesh updated voxels; returns (T, 3, 3) world triangles, or
        None with ``materialize=False`` (the fetch waits for the next
        ``current_mesh()``/``save_ply()``/materialising extract)."""
        if self._need_full_remesh and not no_cache:
            self._need_full_remesh = False
            no_cache = True
        if no_cache:
            return self._extract_chunked(voxel_resolution, max_std, materialize)
        self._dispatch_fused(voxel_resolution, max_std)
        if not materialize:
            return None
        # Materialising extractions drain deferred (budget-truncated)
        # batches to completion; a stalled drain falls to the full re-mesh.
        max_rounds = -(-self.map.cfg.latent_capacity // self.mesh_budget) + 8
        for _ in range(max_rounds):
            if not self._drain_pending():
                break
            self._dispatch_fused(voxel_resolution, max_std)
        else:
            logging.warning("deferral drain stalled after %d rounds; full re-mesh",
                            max_rounds)
            self._need_full_remesh = True
        if self._need_full_remesh:
            self._need_full_remesh = False
            return self._extract_chunked(voxel_resolution, max_std, materialize)
        return self.current_mesh()

    def _dispatch_fused(self, voxel_resolution: int, max_std: float):
        vmap = self.map
        upd, vmap._updated_dev = vmap._updated_dev, None
        if vmap.updated_slots.any():
            h = torch.tensor(vmap.updated_slots, device=vmap.device)   # a copy
            upd = h if upd is None else (upd | h)
            vmap.updated_slots[:] = False
        if upd is None:
            return
        r = int(voxel_resolution)
        if self.reuse_latent_eps > 0.0:
            key = (r, float(max_std))
            if self._mesh_cache is None or self._mesh_cache_key != key:
                C, L = vmap.state.latents.shape
                self._mesh_cache = MeshCache(
                    torch.zeros((C + 1, L), dtype=torch.float32, device=vmap.device),
                    torch.zeros(C + 1, dtype=torch.bool, device=vmap.device))
                self._mesh_cache_key = key
        result, ids, keep, map_ovf, leftover, n_left = fused_extract(
            vmap.state, upd, vmap.cfg, vmap.model.decoder, r,
            self.mesh_budget, self.fused_tri_budget, float(max_std),
            mesh_cache=self._mesh_cache, reuse_eps=self.reuse_latent_eps,
            reuse_counts=self._reuse_counts)
        self._pending.append(_Pending(ids, keep, result, map_ovf, leftover, n_left))

    def _extract_chunked(self, voxel_resolution: int, max_std: float,
                         materialize: bool = True):
        """Full re-mesh of every observed voxel, unbounded: the repair path
        after a batch lost triangles to a device budget (and the
        ``no_cache`` path).  Host bookkeeping in numpy, decode in
        ``MESH_CHUNK``-voxel chunks, one marching-cubes pass.  It neither
        reads nor refreshes the latent-reuse snapshot, so it drops it."""
        self._mesh_cache = None
        self._mesh_cache_key = None
        vmap, cfg = self.map, self.map.cfg
        state = vmap.state
        if bool(state.overflow):
            raise RuntimeError(
                "Map capacity overflow: raise mapping.latent_capacity/alloc_capacity")
        vmap._updated_dev = None
        positions = state.positions.cpu().numpy().astype(np.int64)
        obs = state.obs_count.cpu().numpy()
        indexer = state.indexer.cpu().numpy()
        updated = obs > 0
        self._pending.clear()          # superseded: everything re-meshes
        self.vertices = np.zeros((0, 3, 3), np.float32)
        self.vertices_std = np.zeros((0, 3), np.float32)
        self.vertices_flatten_id = np.zeros((0,), np.int64)
        vmap.updated_slots[:] = False
        # updated voxels and their 6 neighbours, confident ones only
        upd_ids = positions[updated & (positions >= 0)]
        nx, ny, nz = cfg.n_xyz
        xyz = np.stack([upd_ids // (ny * nz), (upd_ids // nz) % ny, upd_ids % nz], 1)
        offs = np.array([[0, 0, 0], [-1, 0, 0], [1, 0, 0], [0, -1, 0],
                         [0, 1, 0], [0, 0, -1], [0, 0, 1]])
        nb = np.clip(xyz[:, None, :] + offs[None], 0, np.array([nx - 1, ny - 1, nz - 1]))
        exp_ids = np.unique((nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2])
        slots = indexer[exp_ids]
        keep = (slots >= 0) & (obs[np.clip(slots, 0, None)] > cfg.ignore_count_th)
        slots, mesh_ids = slots[keep], exp_ids[keep]
        B_real = len(slots)
        if B_real == 0:
            return self.current_mesh() if materialize else None
        r = int(voxel_resolution)
        B = MESH_CHUNK
        n_chunks = -(-B_real // B)
        bucket = 1                     # power-of-two chunk count
        while bucket < n_chunks:
            bucket *= 2
        BT = bucket * B
        dev = vmap.device
        slots_pad = np.zeros((n_chunks * B,), np.int64)
        slots_pad[:B_real] = slots
        shape = (BT, 2 * r, 2 * r, 2 * r)
        cube_sdf = torch.zeros(shape, dtype=torch.float32, device=dev)
        cube_std = torch.zeros(shape, dtype=torch.float32, device=dev)
        for s in range(0, n_chunks * B, B):
            lat = state.latents[torch.as_tensor(slots_pad[s:s + B], device=dev)]
            cube_sdf[s:s + B], cube_std[s:s + B] = decode_cubes(vmap.model.decoder, lat, r)
        ids_b = np.zeros((BT,), np.int64)
        ids_b[:B_real] = mesh_ids
        batch_map = np.full((cfg.latent_capacity,), -1, np.int64)
        batch_map[slots] = np.arange(B_real)
        result = marching_cubes_sparse(
            state.indexer, torch.as_tensor(batch_map, device=dev),
            torch.as_tensor(ids_b, device=dev),
            torch.arange(BT, device=dev) < B_real, cube_sdf, cube_std, cfg.n_xyz,
            cfg.voxel_size, cfg.bound_min, r, cfg.latent_capacity, max_std, self.budget)
        self._pending.append(_Pending(mesh_ids, None, result, None))
        if not materialize:
            return None
        self._drain_pending()
        return self.current_mesh()

    def _drain_pending(self) -> int:
        """Materialise all dispatched extractions into the host cache."""
        pending, self._pending = self._pending, []
        if not pending:
            return 0
        total_leftover = 0
        vmap = self.map
        for p in pending:
            res = p.result
            n = int(res.n_triangles)
            fused = p.keep is not None
            if bool(res.cells_dropped):
                logging.warning("marching-cubes active-cell budget exceeded; "
                                "scheduling full re-mesh")
                self._need_full_remesh = True
            if fused and bool(p.map_ovf):
                raise RuntimeError("Map capacity overflow: raise "
                                   "mapping.latent_capacity/alloc_capacity")
            n_left = int(p.n_leftover) if fused else 0
            if n_left > 0:
                total_leftover += n_left
                vmap._updated_dev = (p.leftover if vmap._updated_dev is None
                                     else vmap._updated_dev | p.leftover)
                logging.info("mesh batch budget %d exceeded; %d voxels deferred "
                             "to the next extraction", self.mesh_budget, n_left)
            ids = p.mesh_ids[p.keep].cpu().numpy() if fused else p.mesh_ids
            cap = self.fused_tri_budget if fused else self.budget
            if n > cap:
                logging.warning("mesh triangle budget exceeded: %d > %d", n, cap)
                if fused:
                    self._need_full_remesh = True
                n = cap
            verts = res.vertices[:n].cpu().numpy()
            vstd = res.vertex_std[:n].cpu().numpy()
            fid = res.flatten_id[:n].cpu().numpy().astype(np.int64)
            # each batch drops every cached triangle of a voxel it re-meshed
            stale = np.isin(self.vertices_flatten_id, ids)
            self.vertices = np.concatenate([self.vertices[~stale], verts])
            self.vertices_std = np.concatenate([self.vertices_std[~stale], vstd])
            self.vertices_flatten_id = np.concatenate(
                [self.vertices_flatten_id[~stale], fid])
        return total_leftover

    def current_mesh(self):
        self._drain_pending()
        return self.vertices

    def save_ply(self, path, color_by_std: bool = True, std_range=None):
        """Binary PLY with jet vertex colours of the uncertainty."""
        self._drain_pending()
        verts = self.vertices.reshape(-1, 3).astype("<f4")
        stds = self.vertices_std.reshape(-1)
        tris = np.arange(len(verts), dtype="<i4").reshape(-1, 3)
        colors = None
        if color_by_std and len(verts):
            lo, hi = (stds.min(), stds.max()) if std_range is None else std_range
            tcol = np.clip((stds - lo) / max(hi - lo, 1e-9), 0, 1)
            colors = (_jet(tcol) * 255).astype(np.uint8)
        vfields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if colors is not None:
            vfields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        vrec = np.zeros(len(verts), dtype=vfields)
        vrec["x"], vrec["y"], vrec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
        if colors is not None:
            vrec["red"], vrec["green"], vrec["blue"] = \
                colors[:, 0], colors[:, 1], colors[:, 2]
        frec = np.zeros(len(tris), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        frec["n"] = 3
        frec["idx"] = tris
        with open(path, "wb") as f:
            hdr = ["ply", "format binary_little_endian 1.0",
                   f"element vertex {len(verts)}",
                   "property float x", "property float y", "property float z"]
            if colors is not None:
                hdr += ["property uchar red", "property uchar green",
                        "property uchar blue"]
            hdr += [f"element face {len(tris)}",
                    "property list uchar int vertex_indices", "end_header"]
            f.write(("\n".join(hdr) + "\n").encode())
            f.write(vrec.tobytes())
            f.write(frec.tobytes())


def _jet(t: np.ndarray) -> np.ndarray:
    """Minimal jet colormap, t in [0, 1] -> (N, 3) rgb."""
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)
