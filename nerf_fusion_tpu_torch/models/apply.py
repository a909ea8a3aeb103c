"""Chunked and grouped network-application helpers.

Counterpart of the JAX package's ``models/apply.py`` (the reference's
``network/utility.py``):

  * ``chunked_apply``  — a forward pass over a point set too large for one
    call, in row chunks (forward_model, network/utility.py:61-126);
  * ``get_samples``    — the r^3 lattice in [a, b]^3 (:129-149);
  * ``groupby_reduce`` — masked segment sum or mean (groupby_sum, :186-208);
  * ``pack_samples``   — a fixed number of random member rows per group
    (pack_batch, :152-183).  Its draws come from a ``torch.Generator``;
    ``pack_rows`` is the deterministic rest, which equals the JAX
    function's on the same permutation and selection.
"""

from __future__ import annotations

import torch

from ..ops import voxel as vox


def _cat(outs):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    if isinstance(first, dict):
        return {k: _cat([o[k] for o in outs]) for k in first}
    return type(first)(_cat(list(xs)) for xs in zip(*outs))


def chunked_apply(fn, inputs: torch.Tensor, max_chunk: int = 1 << 18):
    """``fn`` over axis-0 chunks of at most ``max_chunk`` rows, the outputs
    (a tensor, a tuple or a dict of tensors) concatenated.  Every row is
    computed on its own, so the result equals one call.  The JAX version
    pads the last chunk so that only two program shapes compile; eager
    PyTorch has nothing to compile, so the last chunk runs at its size."""
    n = inputs.shape[0]
    if n <= max_chunk:
        return fn(inputs)
    return _cat([fn(inputs[s:s + max_chunk]) for s in range(0, n, max_chunk)])


def get_samples(r: int, a: float = 0.0, b: float = None) -> torch.Tensor:
    """(r^3, 3) lattice over [a, b]^3, x-major (z varies fastest)."""
    if b is None:
        b = 1.0 - 1.0 / r
    ax = torch.linspace(a, b, r)
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([X, Y, Z], -1).reshape(-1, 3)


def groupby_reduce(sample_indexer: torch.Tensor, sample_values: torch.Tensor,
                   op: str = "mean", num_segments: int = None,
                   valid: torch.Tensor = None) -> torch.Tensor:
    """Group-by ``sum`` or ``mean`` of (N, L) rows into (num_segments, L);
    ``num_segments`` defaults to a host read of max + 1.  An empty group's
    mean is 0."""
    if num_segments is None:
        num_segments = int(sample_indexer.max()) + 1
    if valid is None:
        valid = torch.ones(sample_indexer.shape, dtype=torch.bool,
                           device=sample_indexer.device)
    sums = vox.masked_segment_sum(sample_values, sample_indexer, valid, num_segments)
    if op == "sum":
        return sums
    if op == "mean":
        ones = torch.ones(sample_indexer.shape, dtype=sample_values.dtype,
                          device=sample_values.device)
        cnt = vox.masked_segment_sum(ones, sample_indexer, valid, num_segments)
        return sums / torch.clamp_min(cnt, 1.0)[:, None]
    raise NotImplementedError(op)


def pack_rows(sample_indexer: torch.Tensor, sample_values: torch.Tensor,
              num_segments: int, perm: torch.Tensor, sel: torch.Tensor):
    """The deterministic part of ``pack_samples``: ``perm`` orders the rows
    by segment (members of a segment contiguous), ``sel`` (num_segments,
    count) are non-negative random integers; row ``sel % count_g`` of
    segment g's members is taken.  :return: (packed (num_segments, count,
    L), group_valid (num_segments,))."""
    n = sample_indexer.shape[0]
    sorted_seg = sample_indexer[perm].contiguous()
    segs = torch.arange(num_segments, device=sample_indexer.device,
                        dtype=sorted_seg.dtype)
    first = torch.searchsorted(sorted_seg, segs)
    counts = torch.searchsorted(sorted_seg, segs, right=True) - first
    pick = first[:, None] + sel % torch.clamp_min(counts, 1)[:, None]
    pick = torch.clamp(pick, 0, n - 1)
    return sample_values[perm[pick]], counts > 0


def pack_samples(sample_indexer: torch.Tensor, count: int, sample_values: torch.Tensor,
                 num_segments: int, gen: torch.Generator = None):
    """For each segment, ``count`` of its member rows drawn with replacement
    from ``gen``: the members in a random order (a random key, then a
    stable sort by segment) and a random index into them."""
    n = sample_indexer.shape[0]
    dev = sample_indexer.device
    rand = torch.rand(n, generator=gen, device=dev)
    perm = torch.argsort(rand)
    perm = perm[torch.argsort(sample_indexer[perm], stable=True)]
    sel = torch.randint(0, 1 << 30, (num_segments, count), generator=gen, device=dev)
    return pack_rows(sample_indexer, sample_values, num_segments, perm, sel)
