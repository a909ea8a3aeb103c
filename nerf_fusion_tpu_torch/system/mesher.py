"""Incremental mesh extraction from the latent voxel map.

Counterpart of the JAX package's ``system/mesher.py`` for the fusion loop:

  * ``fused_extract``: updated slots -> 6-neighbour expansion -> dedup ->
    confidence filter -> decoder sample grids (the decoder kernel, in
    512-voxel chunks; all-padding chunks are skipped) -> marching cubes.
    A batch that does not fit ``mesh_budget`` defers its remainder: the
    ``leftover`` slot mask feeds the next extraction.
  * ``decode_cubes(fast=True)``: the reference's fast mode, a coarse r^3
    decode, the align-corners trilinear upsample as one constant
    (n_hi, n_lo) product, and a re-decode of the |sdf| < 0.05 samples up to
    a fixed ``reeval_budget``, scattered back.
  * ``Mesher``: the host triangle cache keyed by owning voxel (every voxel
    of a re-meshed batch drops its stale triangles), deferred fetches
    (``materialize=False``), the deferral drain of materialising
    extractions, the latent-reuse gate (``reuse_latent_eps``), the decode
    mode of every extraction (``mesh_fast``), async extraction on a worker
    thread and PLY export.

The decoder runs in f32 whatever ``mesh_decode_precision`` says; the
upsample product runs in float64 (JAX runs it at ``Precision.HIGHEST``),
so no TF32 setting reaches it.

Async extraction (``extract(extract_async=True)``): the JAX package's
worker reads an immutable state; the port's map is written in place (the
tracker's CUDA graphs read its storage), so the dispatch copies the state
and takes the updated-slot mask on the caller's stream and submits the
extraction to the map's ``Worker`` (``system/worker.py``: one thread and
one CUDA stream, shared with the async refiner).  Its host reads
synchronise the worker's stream; it drains one round (leftovers go back to
the map's host set).  ``current_mesh`` and ``save_ply`` join it first.

Spans (``utils/trace.py``) of an incremental extraction: ``mesher.select``
(up to the host read), ``mesher.keep_read`` (the read of the kept count),
``mesher.decode``, ``mesher.marching_cubes``; ``mesher.drain`` around the
fetch of pending batches.  Counters: ``mesher.extractions`` and
``mesher.voxels_decoded`` (the kept voxels each decodes).
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..ops import voxel as voxops
from ..ops.marching_cubes import marching_cubes_sparse
from ..utils import trace, vis

MESH_CHUNK = 512
_TAKE = object()     # _dispatch_fused: take the updated mask from the map


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


def _coarse_offsets(r: int) -> np.ndarray:
    """r^3 lattice spanning the same extent (fast mode's low resolution)."""
    a = -(r // 2) / r - 0.5
    b = 1.0 + ((r - 1) // 2) / r - 0.5
    ax = np.linspace(a, b, r)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _upsample_blend_matrix(r: int) -> np.ndarray:
    """((2r)^3, r^3) align-corners trilinear upsample as a constant matrix:
    row j holds the <= 8 trilinear weights of high-resolution sample j over
    the coarse lattice, the Kronecker cube of the 1-D resample matrix in
    the row-major (x, y, z) order of the sample grids."""
    j = np.arange(2 * r) * (r - 1) / (2 * r - 1)
    lo = np.floor(j).astype(np.int64)
    hi = np.minimum(lo + 1, r - 1)
    f = (j - lo).astype(np.float32)
    W1 = np.zeros((2 * r, r), np.float32)
    W1[np.arange(2 * r), lo] += 1.0 - f
    W1[np.arange(2 * r), hi] += f
    T = np.einsum("ai,bj,ck->abcijk", W1, W1, W1)
    return T.reshape((2 * r) ** 3, r ** 3)


def _decode(decoder, lat: torch.Tensor, offs: torch.Tensor):
    sdf, std = decoder(torch.cat([lat, offs], dim=1))
    return sdf[:, 0], std[:, 0]


def reeval_budget_for(r: int, fraction: float) -> int:
    """Fast mode's re-decode budget for one ``MESH_CHUNK`` of voxels."""
    return max(1024, int(MESH_CHUNK * (2 * r) ** 3 * fraction))


def upsample_coarse(decoder, latents_b: torch.Tensor, r: int):
    """Fast mode's first half: the coarse r^3 decode of each voxel and its
    upsample to the (2r)^3 grid, ((B * (2r)^3,) sdf, std); the product in
    float64, rounded once to f32."""
    B = latents_b.shape[0]
    n_lo = r ** 3
    offs = torch.as_tensor(_coarse_offsets(r), device=latents_b.device)
    sdf_lo, std_lo = _decode(decoder, latents_b.repeat_interleave(n_lo, dim=0),
                             offs.repeat(B, 1))
    T = torch.as_tensor(_upsample_blend_matrix(r), device=latents_b.device).double()

    def up(v):
        return (v.reshape(B, n_lo).double() @ T.T).to(torch.float32).reshape(-1)

    return up(sdf_lo), up(std_lo)


def decode_cubes(decoder, latents_b: torch.Tensor, r: int, fast: bool = False,
                 valid_b: torch.Tensor = None, reeval_budget: int = 1024):
    """(B, L) voxel latents -> (B, 2r, 2r, 2r) sdf and std sample grids.

    ``fast``: the coarse decode and upsample (``upsample_coarse``), then the
    samples with |sdf| < 0.05 of the ``valid_b`` voxels (all if None),
    in order, up to ``reeval_budget`` of them, decoded again at full
    resolution and scattered back; the rest keep their upsampled values.
    Otherwise every sample is decoded."""
    B = latents_b.shape[0]
    dev = latents_b.device
    shape = (B, 2 * r, 2 * r, 2 * r)
    offs = torch.as_tensor(_sample_offsets(r), device=dev)
    n_hi = offs.shape[0]
    if not fast:
        sdf, std = _decode(decoder, latents_b.repeat_interleave(n_hi, dim=0),
                           offs.repeat(B, 1))
        return sdf.reshape(shape), std.reshape(shape)
    sdf_hi, std_hi = upsample_coarse(decoder, latents_b, r)
    near = sdf_hi.abs() < 0.05
    if valid_b is not None:
        near &= valid_b.repeat_interleave(n_hi)
    sel, sel_valid, _ = voxops.compact_by_mask(
        torch.arange(B * n_hi, device=dev), near, reeval_budget)
    sdf_re, std_re = _decode(decoder, latents_b[sel // n_hi], offs[sel % n_hi])
    dest = torch.where(sel_valid, sel, B * n_hi)
    pad = torch.zeros(1, dtype=torch.float32, device=dev)
    sdf_hi = torch.cat([sdf_hi, pad]).index_copy_(0, dest, sdf_re)[:-1]
    std_hi = torch.cat([std_hi, pad]).index_copy_(0, dest, std_re)[:-1]
    return sdf_hi.reshape(shape), std_hi.reshape(shape)


def fused_extract(state, updated_mask, cfg, decoder, r: int, mesh_budget: int,
                  tri_budget: int, max_std: float, mesh_cache: MeshCache = None,
                  reuse_eps: float = 0.0, reuse_counts: torch.Tensor = None,
                  fast: bool = False, reeval_budget: int = 1024):
    """One incremental extraction (``fast``, ``reeval_budget``: the decode
    mode of ``decode_cubes``).

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
    with trace.span("mesher.select"):
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
    with trace.span("mesher.keep_read"):
        n_keep = int(keep.sum())          # one host read: chunks to decode
    trace.count("mesher.extractions")
    trace.count("mesher.voxels_decoded", n_keep)
    with trace.span("mesher.decode"):
        shape = (mesh_budget, 2 * r, 2 * r, 2 * r)
        # all-padding chunks: inert fill (positive sdf, huge std)
        cube_sdf = torch.ones(shape, dtype=torch.float32, device=dev)
        cube_std = torch.full(shape, 1e6, dtype=torch.float32, device=dev)
        for s in range(0, n_keep, MESH_CHUNK):
            csdf, cstd = decode_cubes(decoder, lat_b[s:s + MESH_CHUNK], r, fast,
                                      keep[s:s + MESH_CHUNK], reeval_budget)
            cube_sdf[s:s + MESH_CHUNK] = csdf
            cube_std[s:s + MESH_CHUNK] = cstd

    with trace.span("mesher.marching_cubes"):
        result = marching_cubes_sparse(
            indexer, batch_map, uniq, keep, cube_sdf, cube_std, cfg.n_xyz,
            cfg.voxel_size, cfg.bound_min, r, C, max_std, tri_budget)
    return result, uniq, keep, state.overflow, leftover, n_leftover


class Mesher:
    """Owns the incremental triangle cache for one map.

    ``mesh_fast`` is the decode mode of every extraction that does not name
    one (``extract(fast=None)``), cadence and final alike;
    ``reeval_fraction`` sizes fast mode's re-decode budget."""

    def __init__(self, vmap, max_n_triangles: int = 1 << 17,
                 mesh_batch_budget: int = 4096, reuse_latent_eps: float = 0.0,
                 mesh_fast: bool = False, reeval_fraction: float = 0.25):
        self.map = vmap
        self.budget = int(max_n_triangles)
        self.mesh_fast = bool(mesh_fast)
        self.reeval_fraction = float(reeval_fraction)
        self.vertices = np.zeros((0, 3, 3), np.float32)
        self.vertices_std = np.zeros((0, 3), np.float32)
        self.vertices_flatten_id = np.zeros((0,), np.int64)
        self._pending = []
        # guards _pending and the host cache: the async worker drains into it
        self._lock = threading.RLock()
        self.mesh_budget = -(-int(mesh_batch_budget) // MESH_CHUNK) * MESH_CHUNK
        self.fused_tri_budget = min(self.budget, max(1 << 15, self.mesh_budget * 64))
        self._need_full_remesh = False
        # Latent-reuse gate (0 disables): the snapshot is keyed by the
        # extraction parameters that shape triangles, (r, max_std[, "fast"]).
        self.reuse_latent_eps = float(reuse_latent_eps)
        self._mesh_cache = None
        self._mesh_cache_key = None
        self._reuse_counts = torch.zeros(2, dtype=torch.int64, device=vmap.device)
        # async extraction: the job on the map's worker, and its counts
        self._future = None
        self.async_started = 0
        self.async_returned = 0

    def reuse_stats(self) -> dict:
        """Updated voxels the gate saw and skipped over the whole run."""
        n_upd, n_skip = self._reuse_counts.tolist()
        return {"updated": n_upd, "skipped": n_skip}

    def join_async(self):
        """Wait for the async extraction, if any; re-raise its error."""
        f, self._future = self._future, None
        err = None if f is None else f.exception()
        if err is not None:
            raise RuntimeError("async mesh extraction failed") from err

    def extract(self, voxel_resolution: int, max_std: float = 2000.0,
                fast: bool = None, no_cache: bool = False, extract_async: bool = False,
                materialize: bool = True):
        """Re-mesh updated voxels; returns (T, 3, 3) world triangles.

        ``fast=None`` takes the Mesher's ``mesh_fast``.  ``extract_async``:
        while an extraction is in flight the call returns None; the first
        call after it ended returns the refreshed cache and starts nothing;
        otherwise the call starts one on a snapshot (module docstring) and
        returns None.  ``materialize=False`` (sync): the fetch waits for the
        next ``current_mesh()``/``save_ply()``/materialising extract."""
        fast = self.mesh_fast if fast is None else bool(fast)
        r = int(voxel_resolution)
        if extract_async:
            if self._future is not None:
                if not self._future.done():
                    return None
                self.join_async()
                self.async_returned += 1
                return self._mesh()
            state = type(self.map.state)(*(t.clone() for t in self.map.state))
            upd = self._take_updated()
            self._future = self.map.worker.submit(
                self._extract_impl, state, upd, r, float(max_std), fast, no_cache,
                drain_deferred=False)
            self.async_started += 1
            return None
        self.join_async()
        return self._extract_impl(self.map.state, self._take_updated(), r, float(max_std),
                                  fast, no_cache, materialize)

    def _take_updated(self):
        """The map's updated-slot accumulators as one device mask (or None),
        cleared."""
        vmap = self.map
        with vmap._upd_lock:
            upd, vmap._updated_dev = vmap._updated_dev, None
            if vmap.updated_slots.any():
                h = torch.tensor(vmap.updated_slots, device=vmap.device)   # a copy
                upd = h if upd is None else (upd | h)
                vmap.updated_slots[:] = False
        return upd

    def _extract_impl(self, state, upd, r: int, max_std: float, fast: bool, no_cache: bool,
                      materialize: bool = True, drain_deferred: bool = True):
        """The extraction on ``state`` with the taken updated mask ``upd``.
        ``drain_deferred=False`` (the async worker): fetch this batch only;
        its leftovers go to the map's host set for the next extraction."""
        if self._need_full_remesh and not no_cache:
            self._need_full_remesh = False
            no_cache = True
        if no_cache:
            return self._extract_chunked(state, r, max_std, fast, materialize)
        self._dispatch_fused(r, max_std, fast, state, upd)
        if not materialize:
            return None
        if not drain_deferred:
            self._drain_pending(host_leftover=True)
            return self.vertices
        # Materialising extractions drain deferred (budget-truncated)
        # batches to completion; a stalled drain falls to the full re-mesh.
        max_rounds = -(-self.map.cfg.latent_capacity // self.mesh_budget) + 8
        for _ in range(max_rounds):
            if not self._drain_pending():
                break
            self._dispatch_fused(r, max_std, fast, state)
        else:
            logging.warning("deferral drain stalled after %d rounds; full re-mesh",
                            max_rounds)
            self._need_full_remesh = True
        if self._need_full_remesh:
            self._need_full_remesh = False
            return self._extract_chunked(state, r, max_std, fast, materialize)
        return self._mesh()

    def _dispatch_fused(self, voxel_resolution: int, max_std: float, fast: bool = None,
                        state=None, upd=_TAKE):
        """One fused extraction of ``state`` (the map's by default) over the
        updated mask ``upd`` (taken from the map by default), left pending."""
        r = int(voxel_resolution)
        fast = self.mesh_fast if fast is None else bool(fast)
        vmap = self.map
        state = vmap.state if state is None else state
        if upd is _TAKE:
            upd = self._take_updated()
        if upd is None:
            return
        if self.reuse_latent_eps > 0.0:
            # the decode mode shapes triangles too
            key = (r, float(max_std)) + (("fast",) if fast else ())
            if self._mesh_cache is None or self._mesh_cache_key != key:
                C, L = state.latents.shape
                self._mesh_cache = MeshCache(
                    torch.zeros((C + 1, L), dtype=torch.float32, device=vmap.device),
                    torch.zeros(C + 1, dtype=torch.bool, device=vmap.device))
                self._mesh_cache_key = key
        result, ids, keep, map_ovf, leftover, n_left = fused_extract(
            state, upd, vmap.cfg, vmap.model.decoder, r,
            self.mesh_budget, self.fused_tri_budget, float(max_std),
            mesh_cache=self._mesh_cache, reuse_eps=self.reuse_latent_eps,
            reuse_counts=self._reuse_counts, fast=fast,
            reeval_budget=reeval_budget_for(r, self.reeval_fraction))
        with self._lock:
            self._pending.append(_Pending(ids, keep, result, map_ovf, leftover, n_left))

    def _extract_chunked(self, state, r: int, max_std: float, fast: bool,
                         materialize: bool = True):
        """Full re-mesh of every observed voxel of ``state``, unbounded: the
        repair path after a batch lost triangles to a device budget (and the
        ``no_cache`` path).  Host bookkeeping in numpy, decode in
        ``MESH_CHUNK``-voxel chunks, one marching-cubes pass.  It neither
        reads nor refreshes the latent-reuse snapshot, so it drops it."""
        self._mesh_cache = None
        self._mesh_cache_key = None
        vmap, cfg = self.map, self.map.cfg
        if bool(state.overflow):
            raise RuntimeError(
                "Map capacity overflow: raise mapping.latent_capacity/alloc_capacity")
        positions = state.positions.cpu().numpy().astype(np.int64)
        obs = state.obs_count.cpu().numpy()
        indexer = state.indexer.cpu().numpy()
        updated = obs > 0
        with self._lock:
            self._pending.clear()          # superseded: everything re-meshes
            self.vertices = np.zeros((0, 3, 3), np.float32)
            self.vertices_std = np.zeros((0, 3), np.float32)
            self.vertices_flatten_id = np.zeros((0,), np.int64)
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
            return self._mesh() if materialize else None
        B = MESH_CHUNK
        n_chunks = -(-B_real // B)
        bucket = 1                     # power-of-two chunk count
        while bucket < n_chunks:
            bucket *= 2
        BT = bucket * B
        dev = vmap.device
        slots_pad = np.zeros((n_chunks * B,), np.int64)
        slots_pad[:B_real] = slots
        valid_pad = torch.arange(n_chunks * B, device=dev) < B_real
        shape = (BT, 2 * r, 2 * r, 2 * r)
        cube_sdf = torch.zeros(shape, dtype=torch.float32, device=dev)
        cube_std = torch.zeros(shape, dtype=torch.float32, device=dev)
        budget = reeval_budget_for(r, self.reeval_fraction)
        for s in range(0, n_chunks * B, B):
            lat = state.latents[torch.as_tensor(slots_pad[s:s + B], device=dev)]
            cube_sdf[s:s + B], cube_std[s:s + B] = decode_cubes(
                vmap.model.decoder, lat, r, fast, valid_pad[s:s + B], budget)
        ids_b = np.zeros((BT,), np.int64)
        ids_b[:B_real] = mesh_ids
        batch_map = np.full((cfg.latent_capacity,), -1, np.int64)
        batch_map[slots] = np.arange(B_real)
        result = marching_cubes_sparse(
            state.indexer, torch.as_tensor(batch_map, device=dev),
            torch.as_tensor(ids_b, device=dev),
            torch.arange(BT, device=dev) < B_real, cube_sdf, cube_std, cfg.n_xyz,
            cfg.voxel_size, cfg.bound_min, r, cfg.latent_capacity, max_std, self.budget)
        with self._lock:
            self._pending.append(_Pending(mesh_ids, None, result, None))
        if not materialize:
            return None
        return self._mesh()

    def _drain_pending(self, host_leftover: bool = False) -> int:
        """Materialise all dispatched extractions into the host cache.
        Leftovers of truncated batches go back to the map's device
        accumulator, or with ``host_leftover`` to its host set."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        with trace.span("mesher.drain"):
            return self._drain(pending, host_leftover)

    def _drain(self, pending: list, host_leftover: bool) -> int:
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
                if host_leftover:
                    left = p.leftover.cpu().numpy()
                    with vmap._upd_lock:
                        vmap.updated_slots |= left
                else:
                    vmap._mark_updated(p.leftover)
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
            with self._lock:
                stale = np.isin(self.vertices_flatten_id, ids)
                self.vertices = np.concatenate([self.vertices[~stale], verts])
                self.vertices_std = np.concatenate([self.vertices_std[~stale], vstd])
                self.vertices_flatten_id = np.concatenate(
                    [self.vertices_flatten_id[~stale], fid])
        return total_leftover

    def _mesh(self):
        self._drain_pending()
        return self.vertices

    def current_mesh(self):
        """The cached triangles, after the async extraction (if any) ended."""
        self.join_async()
        return self._mesh()

    def save_ply(self, path, color_by_std: bool = True, std_range=None):
        """Binary PLY with jet vertex colours of the uncertainty."""
        self.join_async()
        self._drain_pending()
        verts = self.vertices.reshape(-1, 3).astype("<f4")
        stds = self.vertices_std.reshape(-1)
        tris = np.arange(len(verts), dtype="<i4").reshape(-1, 3)
        colors = None
        if color_by_std and len(verts):
            lo, hi = (stds.min(), stds.max()) if std_range is None else std_range
            tcol = np.clip((stds - lo) / max(hi - lo, 1e-9), 0, 1)
            colors = (vis.jet(tcol) * 255).astype(np.uint8)
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

