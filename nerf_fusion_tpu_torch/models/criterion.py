"""Training losses, looked up by name from the config.

Counterpart of the JAX package's ``models/criterion.py`` (the reference's
``network/criterion.py``).  Each loss takes keyword arguments and returns
a dict of named scalar terms; the trainer sums every term.
"""

from __future__ import annotations

import math

import torch


def l1_loss(args, info, pd_sdf, gt_sdf, **kwargs):
    """Clamped L1 (network/criterion.py:10-26)."""
    if args.enforce_minmax:
        gt_sdf = gt_sdf.clamp(-args.clamping_distance, args.clamping_distance)
        pd_sdf = pd_sdf.clamp(-args.clamping_distance, args.clamping_distance)
    return {"sdf": (gt_sdf - pd_sdf).abs().sum() / info["num_sdf_samples"]}


def neg_log_likelihood(args, info, pd_sdf, pd_sdf_std, gt_sdf, **kwargs):
    """Gaussian NLL of the clamped gt under (mu, sigma) (network/criterion.py:29-43)."""
    if args.enforce_minmax:
        gt_sdf = gt_sdf.clamp(-args.clamping_distance, args.clamping_distance)
        pd_sdf = pd_sdf.clamp(-args.clamping_distance, args.clamping_distance)
    mu = pd_sdf.reshape(-1)
    sigma = pd_sdf_std.reshape(-1)
    gt = gt_sdf.reshape(-1)
    nll = 0.5 * ((gt - mu) / sigma) ** 2 + torch.log(sigma) + 0.5 * math.log(2 * math.pi)
    return {"ll": nll.sum() / info["num_sdf_samples"]}


def reg_loss(args, info, latent_vecs, **kwargs):
    """Latent L2 with a 100-epoch warm-up ramp (network/criterion.py:87-92)."""
    l2 = latent_vecs.norm(dim=1).sum()
    warm = min(1.0, info["epoch"] / 100.0)
    return {"reg": warm * l2 / info["num_sdf_samples"] * args.code_reg_lambda}


def siren_loss(args, info, pd_sdf, coords, gt_sdf, **kwargs):
    """SIREN-style boundary / eikonal loss (network/criterion.py:46-80).

    ``gt_sdf`` carries normals; rows whose normal is ~0 are off-surface.
    ``pd_sdf`` must have been computed from ``coords`` with
    ``coords.requires_grad``: the input gradient is taken through autograd
    with ``create_graph`` so the loss can be differentiated again.
    """
    grad, = torch.autograd.grad(pd_sdf, coords, torch.ones_like(pd_sdf),
                                create_graph=True)
    gt_normals = gt_sdf
    on_surface = gt_sdf.abs().sum(-1, keepdim=True) > 1e-6

    zero = torch.zeros_like(pd_sdf)
    sdf_in = torch.where(on_surface, pd_sdf, zero)
    sdf_out = torch.where(on_surface, zero, torch.exp(-1e2 * pd_sdf.abs()))
    cos = (grad * gt_normals).sum(-1, keepdim=True) / (
        grad.norm(dim=-1, keepdim=True)
        * gt_normals.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        + 1e-9)
    normal = torch.where(on_surface, 1.0 - cos, zero)
    eikonal = (grad.norm(dim=-1) - 1.0).abs()
    n = info["num_sdf_samples"]
    return {
        "sdf_in": sdf_in.abs().sum() / n * args.siren_sdf_in,
        "sdf_out": sdf_out.sum() / n * args.siren_sdf_out,
        "normal": normal.sum() / n * args.siren_normal,
        "eikonal": eikonal.sum() / n * args.siren_eikonal,
    }


def get_losses(names):
    registry = {"l1_loss": l1_loss, "neg_log_likelihood": neg_log_likelihood,
                "reg_loss": reg_loss, "siren_loss": siren_loss}
    return [registry[n] for n in names]
