"""PointNet-style point encoder: the eval cnp module and the training module.

The shared per-point MLP ``per_point_feat + [L]`` (6-32-64-256-29 for the
shipped prior) with ReLU after every layer but the last.  Eval BatchNorm
is folded into the weights when the module is built; the forward pass
runs the hand-written CUDA kernel (``ops.mlp``) on the card and its plain
version on the CPU.  Online fusion needs per-point latents only (the
mean-pool is a masked segment-sum over voxels in ``system.map``).

``TrainEncoder`` is the training module of any ``per_point_feat``
(the JAX package's ``models/encoder.py``): BatchNorm in PyTorch's
semantics (batch statistics in training, biased variance to normalise,
the unbiased one into the running estimate, momentum 0.1, eps 1e-5),
masked statistics and a masked mean-pool where a point mask is given
(``nn.BatchNorm1d`` has no mask), no bias on a layer that BN follows.  As
in the JAX trainer, the BN scale and shift are state, not trained.  With
``sync_stats`` (data parallelism) the statistics are those of every rank's
batch together, as JAX takes them over the whole sharded batch
(``nn.SyncBatchNorm`` takes no mask).
``fold()`` gives the eval ``Encoder``'s matrices.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import mlp

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


class Encoder(nn.Module):
    """Eval cnp encoder on folded weights: (N, 6) -> (N, 29)."""

    def __init__(self, mats):
        super().__init__()
        if [tuple(w.shape) for w, _ in mats] != [(6, 32), (32, 64), (64, 256), (256, 29)]:
            raise ValueError("encoder kernel supports only the shipped "
                             "architecture (6-32-64-256-29)")
        for i, (w, b) in enumerate(mats):
            self.register_buffer(f"w{i}", w.contiguous())
            self.register_buffer(f"b{i}", b.contiguous())
        self.register_buffer("packed", mlp.pack_encoder(mats))

    @property
    def mats(self):
        return [(getattr(self, f"w{i}"), getattr(self, f"b{i}")) for i in range(4)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp.encoder_forward(x.contiguous(), self.packed, self.mats)


class EncoderConfig:
    """The encoder's architecture (the JAX package's ``EncoderConfig``)."""

    def __init__(self, latent_size: int, per_point_feat: Sequence[int], bn=None,
                 mode: str = "cnp"):
        if mode not in ("train", "cnp"):
            raise ValueError(f"encoder mode {mode!r} is not train or cnp")
        self.latent_size = latent_size
        self.dims = list(per_point_feat) + [latent_size]
        self.use_bn = bn is not None
        self.mode = mode

    @property
    def n_layers(self):
        return len(self.dims) - 1

    def has_bn(self, layer: int) -> bool:
        # last_act=False in the reference: no BN / activation on the last layer
        return self.use_bn and layer < self.n_layers - 1


def init_encoder(config: EncoderConfig, gen: torch.Generator) -> "TrainEncoder":
    """A ``TrainEncoder`` on the CPU with weights drawn from ``gen`` (torch's
    Conv1d / Linear init) and BN state at (scale 1, shift 0, mean 0, var 1)."""
    params, bn = {}, {}
    for i in range(config.n_layers):
        fan_in, fan_out = config.dims[i], config.dims[i + 1]
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty((fan_out, fan_in)).uniform_(-bound, bound, generator=gen)
        params[f"layer{i}"] = {"w": w}
        if config.has_bn(i):
            bn[f"layer{i}"] = {"scale": torch.ones(fan_out), "bias": torch.zeros(fan_out),
                               "mean": torch.zeros(fan_out), "var": torch.ones(fan_out)}
        else:
            params[f"layer{i}"]["b"] = torch.empty(fan_out).uniform_(-bound, bound,
                                                                      generator=gen)
    return TrainEncoder(config, params, bn)


class _Layer(nn.Module):
    def __init__(self, p: dict, bn: dict = None):
        super().__init__()
        f32 = lambda v: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in p.items():
            self.register_parameter(k, nn.Parameter(f32(v)))
        for k, v in (bn or {}).items():
            self.register_buffer(k, f32(v))


class TrainEncoder(nn.Module):
    """The training encoder: ``forward(x, point_mask)`` on (B, N, F) point
    sets (or (N, F)) -> (B, L) pooled latents in ``train`` mode, per-point
    latents in ``cnp`` mode.  Parameters ``layer{i}.w`` (and ``.b``), BN
    state in the buffers ``layer{i}.{scale,bias,mean,var}``; a forward in
    training mode updates the running mean and variance."""

    def __init__(self, config: EncoderConfig, params: dict, bn: dict):
        super().__init__()
        self.config = config
        self.sync_stats = False
        for i in range(config.n_layers):
            self.add_module(f"layer{i}", _Layer(params[f"layer{i}"], bn.get(f"layer{i}")))

    def forward(self, x: torch.Tensor, point_mask: torch.Tensor = None):
        cfg = self.config
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
            point_mask = None if point_mask is None else point_mask[None]
        w = None if point_mask is None else point_mask[..., None].to(x.dtype)
        h = x
        for i in range(cfg.n_layers):
            layer = getattr(self, f"layer{i}")
            h = torch.matmul(h, layer.w.T)
            if hasattr(layer, "b"):
                h = h + layer.b
            if cfg.has_bn(i):
                if self.training:
                    mean, var, unbiased = self._batch_moments(h, w)
                    with torch.no_grad():
                        layer.mean.copy_((1 - _BN_MOMENTUM) * layer.mean
                                         + _BN_MOMENTUM * mean)
                        layer.var.copy_((1 - _BN_MOMENTUM) * layer.var
                                        + _BN_MOMENTUM * unbiased)
                else:
                    mean, var = layer.mean, layer.var
                h = (h - mean) * torch.rsqrt(var + _BN_EPS) * layer.scale + layer.bias
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
        if cfg.mode == "train":
            if w is not None:
                h = (h * w).sum(1) / w.sum(1).clamp_min(1.0)
            else:
                h = h.mean(1)
        return h[0] if squeeze else h

    def _batch_moments(self, h: torch.Tensor, w: torch.Tensor = None):
        """(mean, biased var, unbiased var) over the valid rows of (B, N, C)
        ``h``; with ``sync_stats`` over the valid rows of every rank's
        batch, the sums all-reduced inside the autograd graph."""
        if self.sync_stats:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce

            total, world = all_reduce, dist.get_world_size()
        else:
            total, world = (lambda t: t), 1
        if w is None:
            cnt = float(h.shape[0] * h.shape[1] * world)
            mean = total(h.sum((0, 1))) / cnt
            var = total(((h - mean) ** 2).sum((0, 1))) / cnt
            return mean, var, var * cnt / max(cnt - 1.0, 1.0)
        cnt = total(w.sum()).clamp_min(1.0)
        mean = total((h * w).sum((0, 1))) / cnt
        var = total((w * (h - mean) ** 2).sum((0, 1))) / cnt
        return mean, var, var * cnt / (cnt - 1.0).clamp_min(1.0)

    def tree(self):
        """(params, bn): the JAX package's pytrees of numpy arrays."""
        params, bn = {}, {}
        for name, layer in self.named_children():
            params[name] = {k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
            if self.config.has_bn(int(name[len("layer"):])):
                bn[name] = {k: v.detach().cpu().numpy() for k, v in layer.named_buffers()}
        return params, bn

    def fold(self) -> list:
        """Eval BatchNorm folded: [(W (in, out), b)] per layer, the eval
        ``Encoder``'s matrices (float64, rounded once to f32)."""
        params, bn = self.tree()
        return mlp.fold_encoder_weights(params, bn, self.config.n_layers, self.config.has_bn)
