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


def in_bounds(grid_id: torch.Tensor, n_xyz) -> torch.Tensor:
    """(..., 3) -> (...,) bool: inside the map's dense extent."""
    n = torch.as_tensor(n_xyz, dtype=grid_id.dtype, device=grid_id.device)
    return torch.all((grid_id >= 0) & (grid_id < n), dim=-1)


def clamp_grid(grid_id: torch.Tensor, n_xyz) -> torch.Tensor:
    n = torch.as_tensor(n_xyz, dtype=grid_id.dtype, device=grid_id.device)
    return torch.minimum(torch.clamp_min(grid_id, 0), n - 1)


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
