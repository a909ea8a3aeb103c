"""PointNet-style point encoder, cnp mode, eval BatchNorm (eval only).

The shared per-point MLP ``per_point_feat + [L]`` (6-32-64-256-29 for the
shipped prior) with ReLU after every layer but the last.  Eval BatchNorm
is folded into the weights when the module is built; the forward pass
runs the hand-written CUDA kernel (``ops.mlp``) on the card and its plain
version on the CPU.  Online fusion needs per-point latents only (the
mean-pool is a masked segment-sum over voxels in ``system.map``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import mlp


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
