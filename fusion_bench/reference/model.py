"""The DI-Fusion prior in plain PyTorch: the SDF decoder and the point encoder.

Decoder (Huang et al., CVPR 2021, ``di_decoder``): input [latent (29),
xyz (3)], hidden 128-128-96-128 with the input re-fed before the fourth
layer, ReLU, ``sdf = tanh(lin4(h))`` and ``std = 0.05 + 0.5 softplus(unc(h))``
from the activation entering the last layer; weight norm folded in float64.
Encoder (``di_encoder``): the per-point MLP 6-32-64-256-29, ReLU after all
but the last layer, eval BatchNorm (eps 1e-5) folded in float64.  Weights
come from the checkpoint's ``.npz`` files, read here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .precision import F32, Precision

LATENT = 29
BN_EPS = 1e-5


def _tree(path: Path) -> dict:
    out = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key], np.float64)
    return out


class Prior:
    """Folded weights on ``device``: ``dec`` [(W (in, out), b)] for lin0-4
    and unc, ``enc`` for the encoder's four layers."""

    def __init__(self, prior_dir, epoch: int, device):
        prior_dir = Path(prior_dir)
        dec = _tree(prior_dir / f"model_{epoch}.npz")
        enc = _tree(prior_dir / f"encoder_{epoch}.npz")
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)
        self.dec = []
        for name in [f"lin{i}" for i in range(5)] + ["unc"]:
            p = dec[name]
            if "v" in p:
                v = t(p["v"])
                w = t(p["g"])[:, None] * v / torch.sqrt(torch.sum(v * v, 1, keepdim=True))
            else:
                w = t(p["w"])
            self.dec.append((w.T, t(p["b"])))
        self.enc = []
        params, bn = enc["params"], enc.get("bn", {})
        for i in range(len(params)):
            p = params[f"layer{i}"]
            w = t(p["w"]).T
            b = t(p["b"]) if "b" in p else torch.zeros(w.shape[1], dtype=torch.float64)
            if f"layer{i}" in bn:
                s = {k: t(v) for k, v in bn[f"layer{i}"].items()}
                scale = s["scale"] / torch.sqrt(s["var"] + BN_EPS)
                w = w * scale[None, :]
                b = (b - s["mean"]) * scale + s["bias"]
            self.enc.append((w, b))
        to = lambda mats: [(w.float().contiguous().to(device), b.float().to(device))
                           for w, b in mats]
        self.dec, self.enc = to(self.dec), to(self.enc)


def _softplus(z):
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def decode(prior: Prior, x: torch.Tensor, prec: Precision = F32):
    """(N, 32) -> (sdf (N,), std (N,))."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wu, bu) = prior.dec
    h = torch.relu(prec.mm(x, w0) + b0)
    h = torch.relu(prec.mm(h, w1) + b1)
    h = torch.relu(prec.mm(h, w2) + b2)
    h = torch.relu(prec.mm(torch.cat([h, x], 1), w3) + b3)
    std = 0.05 + 0.5 * _softplus(prec.mm(h, wu) + bu)
    sdf = torch.tanh(prec.mm(h, w4) + b4)
    return sdf[:, 0], std[:, 0]


def decode_grad(prior: Prior, x: torch.Tensor, prec: Precision = F32):
    """(sdf (N,), std (N,), d sdf / d x[:, 29:32] (N, 3)), the gradient in
    forward mode: three tangents beside the activation, masked by each ReLU."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wu, bu) = prior.dec
    n = x.shape[0]
    a = prec.mm(x, w0) + b0
    m = a > 0
    h = torch.relu(a)
    tan = w0[LATENT:][:, None, :].expand(3, n, w0.shape[1]) * m
    for w, b in ((w1, b1), (w2, b2)):
        a = prec.mm(h, w) + b
        m = a > 0
        h, tan = torch.relu(a), prec.mm(tan, w) * m
    eye = torch.zeros(3, n, x.shape[1], dtype=x.dtype, device=x.device)
    eye[torch.arange(3), :, LATENT + torch.arange(3)] = 1.0
    a = prec.mm(torch.cat([h, x], 1), w3) + b3
    m = a > 0
    h, tan = torch.relu(a), prec.mm(torch.cat([tan, eye], 2), w3) * m
    std = 0.05 + 0.5 * _softplus(prec.mm(h, wu) + bu)
    sdf = torch.tanh(prec.mm(h, w4) + b4)
    grad = (1.0 - sdf * sdf) * prec.mm(tan, w4)[..., 0].T
    return sdf[:, 0], std[:, 0], grad


def encode(prior: Prior, x: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """(N, 6) [rel (3), normal (3)] -> (N, 29) per-point latents."""
    h = x
    for i, (w, b) in enumerate(prior.enc):
        h = prec.mm(h, w) + b
        if i < len(prior.enc) - 1:
            h = torch.relu(h)
    return h
