"""Conditional SDF decoder with an uncertainty head (eval mode).

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
"""

from __future__ import annotations

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
