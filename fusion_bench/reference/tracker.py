"""Camera tracking in plain PyTorch: staged Gauss-Newton on an SDF term and a
photometric term.

A frame's pose is the last pose composed with a delta, found group by group
of the configuration's ``iter_config``: each evaluation builds the normal
equations of the group's terms at the delta and takes one step.  A step
whose energy is worse than the group's best (or not finite) reverts to the
best delta and ends the group; otherwise it solves (H + 1e-9 I) xi = -g and
composes exp(xi) onto the delta; a group runs at most ``n + 1``
evaluations.

SDF term: r = sdf(T p) / std over the first ``gn_points`` of the frame's
box-filtered points, Huber weights, the gradient chained from the decoder's
d sdf / d rel through 1 / (std voxel_size) into the twist of the last
camera.  Photometric term at a pyramid level: the current frame's pixels
(every ``stride``-th, or the ``pixel_budget`` of largest gradient) warped
into the previous frame with rounded coordinates, the intensity residual,
the warp's Jacobian, scaled by ``rgb_weight`` / (valid pixels).
"""

from __future__ import annotations

import math

import torch

from . import geometry as G
from .mapping import map_sdf
from .precision import F32, Precision


def huber(x, k: float):
    ax = torch.abs(x)
    return torch.where(ax > k, k / torch.clamp_min(ax, 1e-12), torch.ones_like(x))


def robust_weight(x, kernel, k: float):
    if kernel is None:
        return torch.ones_like(x)
    if kernel == "huber":
        return huber(x, k)
    raise NotImplementedError(kernel)


def sdf_term(ctx, dR, dt, prec):
    p_delta = G.transform(dR, dt, ctx["pts"], prec)
    p_world = G.transform(ctx["last_R"], ctx["last_t"], p_delta, prec)
    sdf, std, valid, dsdf = map_sdf(ctx["prior"], ctx["map"], ctx["map_cfg"], p_world,
                                    with_grad=True, prec=prec)
    r = sdf / std
    dpos = (torch.ones_like(std) / std)[:, None] * dsdf / ctx["map_cfg"]["voxel_size"]
    m = (ctx["mask"] & valid).to(r.dtype)
    La = prec.mm(ctx["last_R"].T, dpos.T)
    q = p_delta.T
    Lb = torch.stack([q[1] * La[2] - q[2] * La[1], q[2] * La[0] - q[0] * La[2],
                      q[0] * La[1] - q[1] * La[0]], 0)
    J = torch.cat([La, Lb], 0)
    tc = ctx["tcfg"]
    w = robust_weight(r, tc["sdf_robust_kernel"], tc["sdf_robust_k"]) * m
    scale = 1.0 / torch.clamp_min(m.sum(), 1.0)
    return (prec.mm(J * w[None, :], J.T) * scale, prec.mm(J, (w * r)[:, None])[:, 0] * scale,
            torch.sum(r * (w * r)) * scale)


def _warp_index(u0, v0, W: int, H: int):
    inb = (u0 >= 0) & (u0 < W) & (v0 >= 0) & (v0 < H)
    u0c = torch.nan_to_num(u0, nan=0.0).clamp(0, W - 1)
    v0c = torch.nan_to_num(v0, nan=0.0).clamp(0, H - 1)
    return inb, u0c, v0c, (v0c.to(torch.int32) * W + u0c.to(torch.int32))


def _warp_jacobian(ok, d0, u0c, v0c, gx, gy, fx, fy, cx, cy):
    Gx = d0 * (u0c - cx) / fx
    Gy = d0 * (v0c - cy) / fy
    Gz = torch.clamp_min(d0, 1e-6)
    p0 = gx * fx / Gz
    p1 = gy * fy / Gz
    p2 = -(p0 * Gx + p1 * Gy) / Gz
    J = torch.stack([p0, p1, p2, -Gz * p1 + Gy * p2, Gz * p0 - Gx * p2, -Gy * p0 + Gx * p1], 0)
    return torch.where(ok[None], J, torch.zeros_like(J))


def _warp(k, kt, u, v, d1):
    wz = d1 * (k[2, 0] * u + k[2, 1] * v + k[2, 2]) + kt[2]
    u0 = torch.round((d1 * (k[0, 0] * u + k[0, 1] * v + k[0, 2]) + kt[0]) / wz)
    v0 = torch.round((d1 * (k[1, 0] * u + k[1, 1] * v + k[1, 2]) + kt[1]) / wz)
    return wz, u0, v0


def select_pixels(intensity, depth, grad, k: int, min_grad: float, stride: int):
    """The ``k`` stride-grid pixels of largest gradient with finite gradient
    and depth (ties lowest index first): (u, v, i1, d1, gx, gy, valid)."""
    h, w = intensity.shape
    gx, gy = grad[0], grad[1]
    g2 = gx * gx + gy * gy
    ok = torch.isfinite(g2) & (g2 >= min_grad) & torch.isfinite(depth)
    if stride > 1:
        dev = intensity.device
        ok = ok & (torch.arange(h, device=dev)[:, None] % stride == 0) \
            & (torch.arange(w, device=dev)[None, :] % stride == 0)
    score = torch.where(ok, g2, torch.full_like(g2, -1.0)).reshape(-1)
    kk = min(k, ((h - 1) // stride + 1) * ((w - 1) // stride + 1))
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:kk], idx[:kk]
    planes = [p.reshape(-1)[idx] for p in (intensity, depth, gx, gy)]
    return ((idx % w).to(torch.float32), (idx // w).to(torch.float32), *planes, vals >= 0.0)


def rgb_term(ctx, lev: int, dR, dt, prec):
    tc = ctx["tcfg"]
    s = 0.5 ** lev if tc["scale_intrinsics"] else 1.0
    c = ctx["calib"]
    fx, fy, cx, cy = c["fx"] * s, c["fy"] * s, c["cx"] * s, c["cy"] * s
    K, Kinv = ctx["K"][lev]
    krkinv = prec.mm(prec.mm(K, dR), Kinv)
    kt = prec.mm(K, dt[:, None])[:, 0]
    prev = ctx["prev_rows"][lev]
    cur = ctx["cur"]
    H, W = cur["intensity"][lev].shape
    if tc["pixel_budget"] > 0:
        u, v, i1, d1, gx, gy, valid = ctx["selection"][lev]
        wz, u0, v0 = _warp(krkinv, kt, u, v, d1)
        inb, u0c, v0c, lin = _warp_index(u0, v0, W, H)
        got = prev[lin.long().clamp(0, prev.shape[0] - 1)]
        i0, d0 = got[:, 0], got[:, 1]
        ok = valid & inb & torch.isfinite(d0) & (d0 > 0.0) \
            & (torch.abs(wz - d0) <= tc["max_depth_delta"])
        f = torch.where(ok, i1 - i0, torch.zeros_like(i0))
    else:
        stride = tc["stride"]
        i1, d1 = cur["intensity"][lev], cur["depth"][lev]
        gx, gy = cur["gradient"][lev][0], cur["gradient"][lev][1]
        g2 = gx * gx + gy * gy
        if stride > 1:
            keep = torch.isfinite(g2) & (g2 >= tc["min_grad_scale"]) & torch.isfinite(d1) \
                & torch.isfinite(i1)
            dec = lambda p: torch.where(keep, p, torch.zeros_like(d1))[::stride, ::stride]
            i1, d1, gx, gy = dec(i1), dec(d1), dec(gx), dec(gy)
            ok0 = d1 > 0.0
        else:
            ok0 = torch.isfinite(g2) & (g2 >= tc["min_grad_scale"]) & torch.isfinite(d1)
        h, w = i1.shape
        dev = i1.device
        u = (torch.arange(w, dtype=torch.float32, device=dev) * stride)[None, :].expand(h, w)
        v = (torch.arange(h, dtype=torch.float32, device=dev) * stride)[:, None].expand(h, w)
        wz, u0, v0 = _warp(krkinv, kt, u, v, d1)
        inb, u0c, v0c, lin = _warp_index(u0, v0, W, H)
        got = prev[lin.reshape(-1).long().clamp(0, prev.shape[0] - 1)]
        i0, d0 = got[:, 0].reshape(h, w), got[:, 1].reshape(h, w)
        ok = ok0 & inb & torch.isfinite(d0) & (d0 > 0.0) \
            & (torch.abs(wz - d0) <= tc["max_depth_delta"])
        f = torch.where(ok, i1 - i0, torch.zeros_like(i0))
    J = -_warp_jacobian(ok, d0, u0c, v0c, gx, gy, fx, fy, cx, cy)
    m = ok.to(f.dtype)
    w_ = robust_weight(f, tc["rgb_robust_kernel"], tc["rgb_robust_k"]) * m
    scale = torch.reciprocal(torch.clamp_min(m.sum(), 1.0)) * ctx["rgb_weight"]
    J2, f2, w2 = J.reshape(6, -1), f.reshape(-1), w_.reshape(-1)
    return (prec.mm(J2 * w2[None], J2.T) * scale, prec.mm(J2, (w2 * f2)[:, None])[:, 0] * scale,
            torch.sum(f2 * (w2 * f2)) * scale)


def _intrinsics(fx, fy, cx, cy, dev):
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
                     device=dev)
    f = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (fx, fy, cx, cy)]
    Kinv = torch.stack([torch.stack([1.0 / f[0], torch.zeros_like(f[0]), -f[2] / f[0]]),
                        torch.stack([torch.zeros_like(f[0]), 1.0 / f[1], -f[3] / f[1]]),
                        torch.tensor([0.0, 0.0, 1.0], device=dev)])
    return K, Kinv


def used_levels(tcfg) -> list:
    return sorted({int(t[1]) if len(t) > 1 else 0
                   for g in tcfg["iter_config"] for t in g["type"] if t[0] == "rgb"})


def track(prior, map_state, map_cfg, tcfg: dict, calib: dict, prev: dict, cur: dict,
          last_R, last_t, rgb_weight: float, gn_points: int, prec: Precision = F32):
    """The pose (R, t) of the frame ``cur`` (``frontend.preprocess``) after
    the frame ``prev``, whose pose was (last_R, last_t); and the evaluations
    each group ran."""
    dev = last_R.device
    levels = used_levels(tcfg)
    ctx = {"prior": prior, "map": map_state, "map_cfg": map_cfg, "tcfg": tcfg,
           "calib": calib, "cur": cur, "last_R": last_R, "last_t": last_t,
           "pts": cur["points"][:gn_points], "mask": cur["mask"][:gn_points],
           "rgb_weight": rgb_weight,
           "prev_rows": {l: torch.stack([prev["intensity"][l].reshape(-1),
                                         prev["depth"][l].reshape(-1)], -1) for l in levels},
           "K": {}, "selection": {}}
    for lev in levels:
        s = 0.5 ** lev if tcfg["scale_intrinsics"] else 1.0
        ctx["K"][lev] = _intrinsics(calib["fx"] * s, calib["fy"] * s, calib["cx"] * s,
                                    calib["cy"] * s, dev)
        if tcfg["pixel_budget"] > 0:
            ctx["selection"][lev] = select_pixels(
                cur["intensity"][lev], cur["depth"][lev], cur["gradient"][lev],
                tcfg["pixel_budget"], tcfg["min_grad_scale"], tcfg["stride"])
    dR = torch.eye(3, dtype=torch.float32, device=dev)
    dt = torch.zeros(3, dtype=torch.float32, device=dev)
    evals = []
    for group in tcfg["iter_config"]:
        n_iters = int(group["n"])
        bR, bt, best = dR, dt, float("inf")
        i = 0
        while True:
            H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
            g = torch.zeros(6, dtype=torch.float32, device=dev)
            energy = torch.zeros((), dtype=torch.float32, device=dev)
            for term in group["type"]:
                if term[0] == "sdf":
                    Ht, gt, et = sdf_term(ctx, dR, dt, prec)
                else:
                    Ht, gt, et = rgb_term(ctx, int(term[1]) if len(term) > 1 else 0, dR, dt,
                                          prec)
                H, g, energy = H + Ht, g + gt, energy + et
            e = float(energy)
            worse = not (math.isfinite(e) and e <= best)
            if not worse:
                bR, bt, best = dR, dt, e
            i += 1
            if worse or i > n_iters:
                dR, dt = bR, bt
                break
            xi, _ = torch.linalg.solve_ex(H + 1e-9 * torch.eye(6, device=dev), -g)
            if not bool(torch.isfinite(xi).all()):
                xi = torch.zeros_like(xi)
            eR, et_ = G.se3_exp(xi, prec)
            dR, dt = G.compose(eR, et_, dR, dt, prec)
        evals.append(i)
    R, t = G.compose(last_R, last_t, dR, dt, prec)
    return R, t, evals
