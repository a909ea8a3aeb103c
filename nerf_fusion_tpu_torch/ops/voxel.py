"""Fixed-capacity voxel indexing primitives on tensors.

Same contracts as the JAX package's ``ops/voxel.py``: fixed output shapes,
validity masks instead of variable lengths, and overflow flags instead of
reallocation.  Where the JAX code scatters with ``mode="drop"`` into an
out-of-range sentinel, the port scatters into an explicit sentinel row
that is sliced off (an out-of-range index on the card is a device-side
assert, not a silent drop).  Voxel ids are int64 here (the map keeps its
int32 layout in its state and widens at the call).
"""

from __future__ import annotations

import functools

import torch

_BIG = torch.iinfo(torch.int64).max


def linearize_id(xyz: torch.Tensor, n_xyz) -> torch.Tensor:
    """(..., 3) integer grid coords -> (...,) flat id (x-major, z fastest)."""
    return (xyz[..., 0] * n_xyz[1] + xyz[..., 1]) * n_xyz[2] + xyz[..., 2]


def unlinearize_id(idx: torch.Tensor, n_xyz) -> torch.Tensor:
    """(...,) flat id -> (..., 3) grid coords."""
    nyz = n_xyz[1] * n_xyz[2]
    return torch.stack([idx // nyz, (idx // n_xyz[2]) % n_xyz[1], idx % n_xyz[2]], dim=-1)


def world_to_grid(xyz: torch.Tensor, bound_min: torch.Tensor, voxel_size: float):
    """World points -> (coords in voxel units, integer grid id).

    Voxel ``i`` owns ``(i, i + 1]``: grid id = ceil(x_norm) - 1.
    """
    xyz_norm = (xyz - bound_min[None, :]) / voxel_size
    return xyz_norm, torch.ceil(xyz_norm).long() - 1


@functools.lru_cache(maxsize=None)
def _extent(n_xyz: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``n_xyz`` as a (3,) tensor on ``device``, copied there once: a copy
    from the host cannot be captured in a CUDA graph (the tracker's)."""
    return torch.as_tensor(n_xyz, dtype=dtype, device=device)


def in_bounds(grid_id: torch.Tensor, n_xyz) -> torch.Tensor:
    """(..., 3) -> (...,) bool: inside the map's dense extent."""
    n = _extent(tuple(n_xyz), grid_id.dtype, grid_id.device)
    return torch.all((grid_id >= 0) & (grid_id < n), dim=-1)


def clamp_grid(grid_id: torch.Tensor, n_xyz) -> torch.Tensor:
    n = _extent(tuple(n_xyz), grid_id.dtype, grid_id.device)
    return torch.minimum(torch.clamp_min(grid_id, 0), n - 1)


def decoder_rows(xyz: torch.Tensor, bound_min: torch.Tensor, voxel_size: float, n_xyz,
                 indexer: torch.Tensor, obs_count: torch.Tensor, latents: torch.Tensor,
                 count_th: float):
    """The decoder's input at world points ``xyz`` (N, 3): (x (N, L + 3) =
    [the latent of the voxel that holds the point, rel], valid (N,)).

    rel = (xyz - bound_min) / voxel_size - grid - 0.5, the voxel-local
    coordinates; the slot is read from ``indexer`` at the clamped voxel and
    clamped to the latents; valid: the voxel is in bounds, holds a slot and
    its ``obs_count`` exceeds ``count_th``.  An invalid point still gets a
    row (of the clamped slot); callers mask."""
    xyz_norm, grid = world_to_grid(xyz, bound_min, voxel_size)
    inb = in_bounds(grid, n_xyz)
    gid = linearize_id(clamp_grid(grid, n_xyz), n_xyz)
    slot = indexer.long()[gid]
    slot_c = slot.clamp(0, latents.shape[0] - 1)
    valid = inb & (slot >= 0) & (obs_count[slot_c] > count_th)
    rel = xyz_norm - grid.to(torch.float32) - 0.5
    return torch.cat([latents[slot_c], rel], dim=1), valid


def occurrence_count(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per element: how many valid entries share its id (0 where invalid)."""
    if ids.numel() == 0:
        return torch.zeros_like(ids)
    keyed = torch.where(valid, ids, torch.full_like(ids, _BIG))
    _, inverse, counts = torch.unique(keyed, return_inverse=True, return_counts=True)
    return torch.where(valid, counts[inverse], torch.zeros_like(ids))


def masked_unique(ids: torch.Tensor, valid: torch.Tensor, capacity: int):
    """Unique valid ids, ascending, compacted into a ``capacity`` buffer.

    :return: (unique_ids (capacity,), unique_valid (capacity,) bool,
              n_unique () clamped to capacity, overflow () bool).
    """
    keyed = torch.where(valid, ids, torch.full_like(ids, _BIG))
    s, _ = torch.sort(keyed)
    is_first = torch.ones_like(s, dtype=torch.bool)
    is_first[1:] = s[1:] != s[:-1]
    is_first &= s != _BIG
    rank = torch.cumsum(is_first, 0) - 1
    n_unique = is_first.sum()
    dest = torch.where(is_first & (rank < capacity), rank, capacity)
    out = torch.zeros(capacity + 1, dtype=ids.dtype, device=ids.device)
    out.index_copy_(0, dest, s)
    out = out[:capacity]
    uvalid = torch.arange(capacity, device=ids.device) < n_unique
    return (torch.where(uvalid, out, torch.zeros_like(out)), uvalid,
            torch.clamp_max(n_unique, capacity), n_unique > capacity)


def compact_by_mask(values: torch.Tensor, mask: torch.Tensor, capacity: int, fill=0):
    """``values[mask]`` in order into a fixed ``capacity`` buffer.

    :return: (out (capacity, ...), out_valid (capacity,), n () clamped).
    """
    rank = torch.cumsum(mask, 0) - 1
    n = mask.sum()
    dest = torch.where(mask & (rank < capacity), rank, capacity)
    out = torch.full((capacity + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out.index_copy_(0, dest, values)
    out_valid = torch.arange(capacity, device=values.device) < n
    return out[:capacity], out_valid, torch.clamp_max(n, capacity)


def masked_segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                       valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment-sum of ``values`` rows into ``num_segments`` buckets.

    Invalid rows go to a discard bucket.  On the card ``index_add_`` adds
    with atomics in an order that varies from run to run, so sums agree
    with a sequential sum to f32 rounding, not bit for bit.
    """
    seg = torch.where(valid, seg_ids, torch.full_like(seg_ids, num_segments))
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, seg, values)
    return out[:num_segments]


def masked_segment_max(values: torch.Tensor, seg_ids: torch.Tensor,
                       valid: torch.Tensor, num_segments: int,
                       fill_value=None) -> torch.Tensor:
    """Segment-max of ``values`` rows into ``num_segments`` buckets; invalid
    rows go to a discard bucket.  An empty bucket holds the identity of the
    max (``jax.ops.segment_max``'s: -inf for a float type, the lowest value
    for an integer one), or ``fill_value`` where one is given.  No path of
    the loop calls it (the reference's groupby-max, exported but unused)."""
    seg = torch.where(valid, seg_ids, torch.full_like(seg_ids, num_segments)).long()
    if values.dtype.is_floating_point:
        identity = float("-inf")
    else:
        identity = torch.iinfo(values.dtype).min
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]), identity,
                     dtype=values.dtype, device=values.device)
    idx = seg.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out = out.scatter_reduce(0, idx, values, reduce="amax")[:num_segments]
    if fill_value is not None:
        hit = torch.zeros(num_segments + 1, dtype=torch.bool, device=values.device)
        hit[seg] = True
        empty = ~hit[:num_segments].reshape((-1,) + (1,) * (values.dim() - 1))
        out = torch.where(empty, torch.full_like(out, fill_value), out)
    return out


_NEIGHBORS6 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
               (0, 0, -1), (0, 0, 1))


def expand_neighbors6(flat_ids: torch.Tensor, valid: torch.Tensor, n_xyz):
    """Each id -> itself + its 6 axis neighbours (clamped to bounds).

    :return: ((7N,) ids, (7N,) valid).
    """
    xyz = unlinearize_id(flat_ids, n_xyz)
    offsets = torch.as_tensor(_NEIGHBORS6, dtype=xyz.dtype, device=xyz.device)
    nb = clamp_grid(xyz[:, None, :] + offsets[None, :, :], n_xyz)
    nb_valid = valid[:, None].expand(valid.shape[0], 7).reshape(-1)
    return linearize_id(nb, n_xyz).reshape(-1), nb_valid
