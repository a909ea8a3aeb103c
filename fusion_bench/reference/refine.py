"""Latent refinement in plain PyTorch: DI-Fusion's ``OptimizeProcess``.

After a frame is integrated, the latents of the eligible voxels (allocated,
``obs_count >= encoder_count_th``, never refined before) take ``n_iters``
Adam steps.  Each valid point of the frame, moved to the world frame by the
pose, is paired with the voxel of each of its 8 half-voxel corners; a pair
counts where that voxel is eligible.  Its sample is the point's position
in that voxel moved along the point's normal by its jitter (an input: the
program draws it on the device), and its target is the jitter clipped to
+-0.2.  The loss is the Gaussian NLL of the target under the decoder's
clipped sdf and its std, summed over the pairs that count, plus
``code_reg_lambda`` times the sum of the eligible latents' norms, both over
the count of those pairs (at least 1).  Adam as the program writes it: the
gradient masked by eligibility, bias correction with ``i + 1``.  The
refined latents replace the eligible ones, which are marked refined.

The latent gradient comes from autograd through the plain decoder
(``model.decode``); each of its products runs at the reference's precision
forward and backward, so ``CONTROL`` refines with TF32 products.  Only the
pairs that count are decoded: the others add nothing to the loss or its
gradient.
"""

from __future__ import annotations

import torch

from . import geometry as G
from .mapping import CORNERS
from .model import decode
from .precision import F32, Precision


class _Product(torch.autograd.Function):
    """``prec.mm(a, b)`` with its backward at the same precision."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return prec.mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = ctx.prec.mm(g, b.T) if ctx.needs_input_grad[0] else None
        gb = ctx.prec.mm(a.T, g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


class _Differentiable(Precision):
    def __init__(self, prec: Precision):
        super().__init__(prec.control)
        self.prec = prec

    def mm(self, a, b):
        return _Product.apply(a, b, self.prec)


def targets(state: dict, cfg: dict, points, normals, valid, R, t, gt_sdf, clip: float,
            prec: Precision = F32):
    """(eligible (C,), slot (M,), pos (M, 3), target (M,), pairs (8N,) bool) of
    the camera-frame cloud at the camera-to-world pose (R, t): the M corner
    pairs that count."""
    pts = G.transform(R, t, points, prec)
    nrm = prec.mm(normals, R.T)
    C, n_xyz = cfg["latent_capacity"], cfg["n_xyz"]
    eligible = (state["positions"] >= 0) & (state["obs_count"] >= cfg["encoder_count_th"]) \
        & ~state["optimized"]
    bmin = torch.as_tensor(cfg["bound_min"], dtype=torch.float32, device=pts.device)
    xyz_norm = (pts - bmin[None, :]) / cfg["voxel_size"]
    offs = torch.as_tensor(CORNERS, device=pts.device)
    tgt = G.clamp_grid(torch.ceil(xyz_norm[:, None, :] + offs[None]).long() - 1, n_xyz)
    rel = xyz_norm[:, None, :] - tgt.to(torch.float32) - 0.5
    tgt_slot = state["indexer"].long()[G.linearize(tgt, n_xyz)]
    slot = tgt_slot.clamp(0, C - 1)
    pairs = (valid[:, None] & (tgt_slot >= 0) & eligible[slot]).reshape(-1)
    pos = (rel + gt_sdf[..., None] * nrm[:, None, :]).reshape(-1, 3)
    return (eligible, slot.reshape(-1)[pairs], pos[pairs],
            gt_sdf.reshape(-1)[pairs].clamp(-clip, clip), pairs)


def refine(prior, state: dict, cfg: dict, rcfg: dict, points, normals, valid, R, t, gt_sdf,
           prec: Precision = F32) -> dict:
    """The map after refining ``state`` against the frame's camera-frame
    cloud at pose (R, t) with the jitter ``gt_sdf`` (N, 8); ``rcfg``: the
    configuration's ``refine`` block.  Adds ``eligible`` (C,), ``nll``
    (n_iters,) the mean NLL before each step, ``sampled`` (voxels with a
    pair that counts) and ``pairs``."""
    eligible, slot, pos, target, pairs = targets(state, cfg, points, normals, valid, R, t,
                                                 gt_sdf, float(rcfg["target_clip"]), prec)
    n = torch.clamp_min(pairs.sum().to(torch.float32), 1.0)
    lam = float(rcfg["code_reg_lambda"])
    lr, (b1, b2), eps = float(rcfg["lr"]), rcfg["adam_betas"], float(rcfg["adam_eps"])
    mask = eligible[:, None].to(torch.float32)
    dprec = _Differentiable(prec)
    lat = state["latents"].clone()
    m, v = torch.zeros_like(lat), torch.zeros_like(lat)
    nlls = []
    for i in range(int(rcfg["n_iters"])):
        x = lat.detach().requires_grad_()
        with torch.enable_grad():
            sdf, std = decode(prior, torch.cat([x[slot], pos], 1), dprec)
            mu = sdf.clamp(-0.2, 0.2)
            ll = torch.sum(0.5 * ((target - mu) / std) ** 2 + torch.log(std)) / n
            reg = lam * torch.sum(torch.linalg.vector_norm(x, dim=1) * eligible) / n
            (g,) = torch.autograd.grad(ll + reg, x)
        nlls.append(ll.detach())
        g = g * mask
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mh = m / (1.0 - b1 ** (i + 1.0))
        vh = v / (1.0 - b2 ** (i + 1.0))
        lat = lat - lr * mh / (torch.sqrt(vh) + eps)
    out = dict(state)
    out.update(latents=torch.where(eligible[:, None], lat, state["latents"]),
               optimized=state["optimized"] | eligible, eligible=eligible,
               nll=torch.stack(nlls) if nlls else torch.zeros(0, device=lat.device),
               sampled=int(torch.unique(slot).numel()), pairs=int(pairs.sum()))
    return out


def merge_async(state: dict, latents, refined, old_latents, old_counts) -> dict:
    """``state`` after merging a refinement that ran on a copy of an earlier
    map (DI-Fusion's de-integration merge): over the ``refined`` slots,
    ``cur + (opt - old) * old_count / cur_count``, so that what was fused
    into them since the copy stays, and those slots marked refined.
    ``latents`` (opt), ``old_latents`` and ``old_counts``: the refinement's
    result and the copy's latents and counts."""
    cur = torch.clamp_min(state["obs_count"], 1.0)[:, None]
    merged = state["latents"] + (latents - old_latents) * old_counts[:, None] / cur
    out = dict(state)
    out.update(latents=torch.where(refined[:, None], merged, state["latents"]),
               optimized=state["optimized"] | refined)
    return out
