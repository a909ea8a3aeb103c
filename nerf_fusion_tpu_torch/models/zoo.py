"""Layer-factory zoo: a generic MLP and the PointNet-style shared MLP.

Counterpart of the JAX package's ``models/zoo.py`` (the reference's
``utils/pt_util.py`` FC / SharedMLP factories).  A list of widths builds
an ``MLP`` whose parameters carry the JAX pytree's keys
(``layer{i}.w`` (out, in), ``layer{i}.b``, ``norm{i}.scale`` /
``norm{i}.bias``): with ``bn`` every hidden layer has no bias and is
followed by a per-row normalisation over its features (biased variance,
eps 1e-5) and an affine.  ``models.io.mlp_from_jax`` loads the JAX
package's parameters.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .decoder import _linear_init

_NORM_EPS = 1e-5


class MLP(nn.Module):
    """``dims[0] -> ... -> dims[-1]``, ReLU between the layers and, with
    ``last_act``, after the last.  Weights drawn from
    ``gen`` as the JAX ``init_mlp`` draws them (uniform in +-1/sqrt(fan_in)),
    norm state at scale 1, shift 0."""

    def __init__(self, dims: Sequence[int], bn: bool = False, gen: torch.Generator = None,
                 last_act: bool = False):
        super().__init__()
        self.dims = list(dims)
        self.last_act = last_act
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        n = len(self.dims) - 1
        for i in range(n):
            w, b = _linear_init(self.dims[i], self.dims[i + 1], gen)
            layer = nn.Module()
            layer.w = nn.Parameter(w)
            normed = bn and i < n - 1
            if not normed:
                layer.b = nn.Parameter(b)
            self.add_module(f"layer{i}", layer)
            if normed:
                norm = nn.Module()
                norm.scale = nn.Parameter(torch.ones(self.dims[i + 1]))
                norm.bias = nn.Parameter(torch.zeros(self.dims[i + 1]))
                self.add_module(f"norm{i}", norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.dims) - 1
        for i in range(n):
            layer = getattr(self, f"layer{i}")
            x = torch.matmul(x, layer.w.T)
            if hasattr(layer, "b"):
                x = x + layer.b
            norm = getattr(self, f"norm{i}", None)
            if norm is not None:
                mu = x.mean(dim=-1, keepdim=True)
                var = x.var(dim=-1, keepdim=True, unbiased=False)
                x = (x - mu) * torch.rsqrt(var + _NORM_EPS) * norm.scale + norm.bias
            if i < n - 1 or self.last_act:
                x = torch.relu(x)
        return x


class SharedMLP(MLP):
    """The per-point MLP on (B, N, F) point sets; ``forward(points,
    point_mask=None, pool=None)`` pools over the points with a masked
    ``mean`` (an empty set gives 0) or ``max`` (an empty set gives -inf)."""

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor = None,
                pool: str = None) -> torch.Tensor:
        h = super().forward(points)
        if pool is None:
            return h
        if point_mask is None:
            point_mask = torch.ones(h.shape[:-1], dtype=torch.bool, device=h.device)
        if pool == "mean":
            m = point_mask[..., None].to(h.dtype)
            return (h * m).sum(-2) / torch.clamp_min(m.sum(-2), 1.0)
        if pool == "max":
            neg = torch.where(point_mask[..., None], h, torch.full_like(h, -math.inf))
            return neg.amax(-2)
        raise NotImplementedError(pool)
