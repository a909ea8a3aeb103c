"""Conditional SDF decoder with an uncertainty head: eval and training modules.

Architecture of the DeepSDF-style di_decoder: input ``[latent (L), xyz (3)]``,
hidden widths 128-128-96-128 with the input re-injected before the fourth
layer, ``std = 0.05 + 0.5 softplus(unc(h))`` read from the activation
entering the last layer, and ``sdf = tanh(lin4(h))``.  Weight-norm is
folded into plain (in, out) matrices when the module is built; the forward
pass runs the hand-written CUDA kernel (``ops.mlp``) on the card and its
plain version on the CPU; ``ops.mlp.decoder_forward_grad`` on the packed
weights adds the input gradient (``system.map.get_sdf``).  Matrix products are f32, or on the card the
3xTF32 split, which is as exact (not one-pass TF32): the tracker's
Jacobians need those digits.

``TrainDecoder`` is the training module of any architecture that
``DecoderConfig`` describes (the JAX package's ``models/decoder.py``):
weight-norm ``v`` / ``g`` / ``b`` parameters, dropout drawn from an
explicit generator, plain PyTorch products under autograd.  ``fold()``
gives the eval ``Decoder``'s matrices.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import mlp


class Decoder(nn.Module):
    """Eval decoder on folded weights: ``forward(net_in)`` -> (sdf, std)."""

    def __init__(self, mats):
        super().__init__()
        if ([tuple(w.shape) for w, _ in mats]
                != [(32, 128), (128, 128), (128, 96), (128, 128), (128, 1), (128, 1)]):
            raise ValueError("decoder kernel supports only the shipped "
                             "architecture (latent 29, hidden 128, latent_in [3])")
        for i, (w, b) in enumerate(mats):
            self.register_buffer(f"w{i}", w.contiguous())
            self.register_buffer(f"b{i}", b.contiguous())
        self.register_buffer("packed", mlp.pack_decoder(mats))

    @property
    def mats(self):
        return [(getattr(self, f"w{i}"), getattr(self, f"b{i}")) for i in range(6)]

    def forward(self, net_in: torch.Tensor):
        """(N, 32) -> (sdf (N, 1), std (N, 1))."""
        out = mlp.decoder_forward(net_in.contiguous(), self.packed, self.mats)
        return out[:, 0:1], out[:, 1:2]


class DecoderConfig:
    """The decoder's architecture (the JAX package's ``DecoderConfig``)."""

    def __init__(self, latent_size: int, dims: Sequence[int], dropout=None,
                 dropout_prob: float = 0.0, norm_layers=(), latent_in=(),
                 weight_norm: bool = False):
        self.latent_size = latent_size
        self.dims = [latent_size + 3] + list(dims) + [1]
        self.num_layers = len(self.dims)
        self.dropout = list(dropout) if dropout is not None else None
        self.dropout_prob = dropout_prob
        self.norm_layers = list(norm_layers)
        self.latent_in = list(latent_in)
        self.weight_norm = weight_norm

    def layer_shapes(self):
        """Yield (layer_idx, in_dim, out_dim) for each Linear.  The layer
        before a ``latent_in`` layer shrinks its output by ``dims[0]``, so
        the width after re-concatenating the input is ``dims[layer]``
        (di_decoder.py:32-35)."""
        for layer in range(self.num_layers - 1):
            out_dim = self.dims[layer + 1]
            if layer + 1 in self.latent_in:
                out_dim -= self.dims[0]
            yield layer, self.dims[layer], out_dim

    def has_weight_norm(self, layer: int) -> bool:
        return self.weight_norm and layer in self.norm_layers


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)


def _linear_init(fan_in: int, fan_out: int, gen: torch.Generator):
    """torch.nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    w = _uniform((fan_out, fan_in), bound, gen)
    return w, _uniform((fan_out,), bound, gen)


def init_decoder(config: DecoderConfig, gen: torch.Generator) -> "TrainDecoder":
    """A ``TrainDecoder`` on the CPU with weights drawn from ``gen``; a
    weight-norm layer's ``g`` starts at the row norms of ``v``."""
    tree = {}
    for layer, in_dim, out_dim in config.layer_shapes():
        w, b = _linear_init(in_dim, out_dim, gen)
        if config.has_weight_norm(layer):
            tree[f"lin{layer}"] = {"v": w, "g": w.norm(dim=1), "b": b}
        else:
            tree[f"lin{layer}"] = {"w": w, "b": b}
    uw, ub = _linear_init(config.dims[-2], 1, gen)
    tree["unc"] = {"w": uw, "b": ub}
    return TrainDecoder(config, tree)


def dropout(x: torch.Tensor, p: float, gen: torch.Generator) -> torch.Tensor:
    """Each entry kept with probability 1 - p and scaled by 1 / (1 - p),
    drawn from ``gen`` (on ``x``'s device)."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class TrainDecoder(nn.Module):
    """The training decoder: ``forward(net_in, gen)`` -> (sdf, std).

    Parameters are named ``lin{i}.{v,g,b}`` (``lin{i}.{w,b}`` without
    weight norm) and ``unc.{w,b}``, the JAX package's pytree keys.  The
    input is re-fed before each ``latent_in`` layer, ``std`` reads the
    activation entering the last layer, and in training mode each listed
    hidden ReLU is followed by dropout drawn from ``gen``
    (di_decoder.py:55-86).
    """

    def __init__(self, config: DecoderConfig, tree: dict):
        super().__init__()
        self.config = config
        for name, p in tree.items():
            self.add_module(name, nn.ParameterDict(
                {k: nn.Parameter(torch.from_numpy(np.array(v, dtype=np.float32)))
                 for k, v in p.items()}))

    @staticmethod
    def _linear(p: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
        if "v" in p:
            v = p["v"]
            w = p["g"][:, None] * v / v.norm(dim=1, keepdim=True)
        else:
            w = p["w"]
        return torch.addmm(p["b"], x, w.T)

    def forward(self, net_input: torch.Tensor, gen: torch.Generator = None):
        cfg = self.config
        drop = (self.training and cfg.dropout is not None and cfg.dropout_prob > 0.0)
        if drop and gen is None:
            raise ValueError("dropout in training mode needs a generator")
        x, std = net_input, None
        n_lin = cfg.num_layers - 1
        for layer in range(n_lin):
            if layer in cfg.latent_in:
                x = torch.cat([x, net_input], dim=1)
            if layer == n_lin - 1:
                std = 0.05 + 0.5 * nn.functional.softplus(self._linear(self.unc, x))
            x = self._linear(getattr(self, f"lin{layer}"), x)
            if layer < n_lin - 1:
                x = torch.relu(x)
                if drop and layer in cfg.dropout:
                    x = dropout(x, cfg.dropout_prob, gen)
        return torch.tanh(x), std

    def tree(self) -> dict:
        """The parameters as the JAX package's pytree of numpy arrays."""
        return {name: {k: v.detach().cpu().numpy() for k, v in p.items()}
                for name, p in self.named_children()}

    def fold(self) -> list:
        """Weight norm folded: [(W (in, out), b)] for lin0, lin1, ... and unc,
        the eval ``Decoder``'s matrices for the shipped architecture
        (float64, rounded once to f32)."""
        return mlp.fold_decoder_weights(self.tree())


def decoder_param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
