"""Tensor parallelism of the decoder: the JAX package's ``tp`` layout.

Counterpart of ``shard_decoder_params`` in the JAX package's
``parallel/mesh.py``.  Over ``tp`` ranks of a ``torch.distributed`` group,
every decoder weight (2-D) or vector (1-D) whose first dimension is
divisible by ``tp`` and at least 64 is split by rows: rank k keeps rows
[k n / tp, (k + 1) n / tp).  Everything else is replicated.  Since the
first dimension of a weight is its output features (the JAX pytree keeps
PyTorch's (out, in) layout), a split layer computes its slice of the
output features on each rank, and an ``all_gather`` along the features
gives every rank the whole activation for the next layer.  Weight norm
normalises each row of ``v``, so it needs nothing from the other ranks.

This is a layout, not a speed-up: the shipped decoder is 128 wide, and one
card holds it whole.  ``tools/tp_check.py`` holds the sharded forward
against the unsharded one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models.decoder import DecoderConfig, TrainDecoder

MIN_ROWS = 64


def is_split(shape, tp: int) -> bool:
    """The JAX rule: a 1-D or 2-D tensor whose first dimension divides by
    ``tp`` and is at least ``MIN_ROWS`` is split by rows (for ``tp`` > 1)."""
    return tp > 1 and len(shape) in (1, 2) and shape[0] % tp == 0 and shape[0] >= MIN_ROWS


def shard_decoder_params(tree: dict, rank: int, tp: int):
    """This rank's shard of a decoder pytree ({layer: {name: array}}): the
    split tensors' rows of ``rank``, the others whole, as f32 tensors; and
    which tensors are split ({layer: {name: bool}})."""
    shard, split = {}, {}
    for layer, params in tree.items():
        shard[layer], split[layer] = {}, {}
        for k, v in params.items():
            v = torch.as_tensor(v, dtype=torch.float32)
            split[layer][k] = is_split(tuple(v.shape), tp)
            if split[layer][k]:
                n = v.shape[0] // tp
                v = v[rank * n:(rank + 1) * n]
            shard[layer][k] = v.contiguous()
    return shard, split


def _linear(p: dict, split: dict, x: torch.Tensor, tp: int, group=None) -> torch.Tensor:
    """A layer on this rank's shard; a split layer's output features are
    gathered from every rank (weights and bias share their first dimension,
    so a layer is split whole or not at all)."""
    y = TrainDecoder._linear(p, x)
    if any(split.values()):
        parts = [torch.empty_like(y) for _ in range(tp)]
        dist.all_gather(parts, y.contiguous(), group=group)
        y = torch.cat(parts, dim=1)
    return y


def apply_decoder_tp(shard: dict, split: dict, config: DecoderConfig,
                     net_input: torch.Tensor, tp: int, group=None):
    """The eval decoder's forward (``TrainDecoder`` in eval mode) on this
    rank's shard (``shard_decoder_params``): (N, L + 3) -> (sdf (N, 1),
    std (N, 1)), the same on every rank.  Every rank of the group calls it."""
    x, std = net_input, None
    n_lin = config.num_layers - 1
    for layer in range(n_lin):
        if layer in config.latent_in:
            x = torch.cat([x, net_input], dim=1)
        if layer == n_lin - 1:
            std = 0.05 + 0.5 * nn.functional.softplus(
                _linear(shard["unc"], split["unc"], x, tp, group))
        name = f"lin{layer}"
        x = _linear(shard[name], split[name], x, tp, group)
        if layer < n_lin - 1:
            x = torch.relu(x)
    return torch.tanh(x), std
