"""The benchmark's frozen renderer: analytic SDF scenes, sphere-traced on the device.

A plain-PyTorch copy of the synthetic sequence the fusion loop was built on
(the room and the two-room apartment, their procedural texture and shading,
a 96-step sphere trace), made data-driven: a scene is a list of primitives
read from a traffic file, a trajectory is a kind with its parameters.  The
benchmark renders each cell's frames with it during set-up and hands them to
the program; the reference reads the same scenes as its ground truth.

Primitives (each a dict with ``kind``): ``plane`` (``axis``, ``sign``,
``offset``: sign * p[axis] + offset), ``sphere`` (``center``, ``radius``),
``box`` (``center``, ``half``), ``cylinder_y`` (``center_xz``, ``radius``,
``y_center``, ``half_height``).  The scene's SDF is their minimum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_TRACE_STEPS = 96


def _box(p, center, half):
    q = torch.abs(p - p.new_tensor(center)) - p.new_tensor(half)
    return torch.linalg.vector_norm(torch.clamp_min(q, 0.0), dim=-1) \
        + torch.clamp_max(torch.amax(q, dim=-1), 0.0)


def _primitive(p, prim):
    kind = prim["kind"]
    if kind == "plane":
        return prim["sign"] * p[..., prim["axis"]] + prim["offset"]
    if kind == "sphere":
        return torch.linalg.vector_norm(p - p.new_tensor(prim["center"]), dim=-1) \
            - prim["radius"]
    if kind == "box":
        return _box(p, prim["center"], prim["half"])
    if kind == "cylinder_y":
        dxz = torch.stack([
            torch.linalg.vector_norm(p[..., ::2] - p.new_tensor(prim["center_xz"]), dim=-1)
            - prim["radius"],
            torch.abs(p[..., 1] - prim["y_center"]) - prim["half_height"]], -1)
        return torch.clamp_max(torch.amax(dxz, dim=-1), 0.0) \
            + torch.linalg.vector_norm(torch.clamp_min(dxz, 0.0), dim=-1)
    raise ValueError(f"unknown scene primitive {kind!r}")


def scene_sdf(p: torch.Tensor, primitives) -> torch.Tensor:
    """The scene's SDF at world points p (..., 3), y up."""
    out = None
    for prim in primitives:
        s = _primitive(p, prim)
        out = s if out is None else torch.minimum(out, s)
    return out


def albedo(p: torch.Tensor) -> torch.Tensor:
    """Procedural texture, so that the photometric term has real gradients."""
    checker = torch.remainder(torch.floor(p[..., 0] * 3) + torch.floor(p[..., 2] * 3), 2)
    stripes = 0.5 + 0.5 * torch.sin(7.0 * p[..., 0]) * torch.sin(5.0 * p[..., 1])
    base = 0.35 + 0.4 * checker[..., None] * p.new_tensor([0.9, 0.6, 0.3]) \
        + 0.25 * stripes[..., None] * p.new_tensor([0.2, 0.5, 0.9])
    return torch.clamp(base, 0.05, 1.0)


def render(R, t, fx, fy, cx, cy, H: int, W: int, primitives):
    """Sphere-trace B frames at once.  R (B, 3, 3), t (B, 3) camera-to-world
    float32 on the device.  :return: rgb (B, H, W, 3) in [0, 1], depth
    (B, H, W) z-depth in metres, NaN where the ray hits nothing."""
    dev = R.device
    sdf = lambda q: scene_sdf(q, primitives)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    d_world = torch.einsum("hwj,bij->bhwi", d_cam, R)
    origin = t[:, None, None, :]
    t_ray = torch.full(d_world.shape[:-1], 0.05, dtype=torch.float32, device=dev)
    for _ in range(N_TRACE_STEPS):
        t_ray = t_ray + torch.clamp(sdf(origin + t_ray[..., None] * d_world), 0.0, 0.4)
    p_hit = origin + t_ray[..., None] * d_world
    hit = (torch.abs(sdf(p_hit)) < 5e-3) & (t_ray < 12.0)
    depth = torch.where(hit, t_ray * d_cam[..., 2], torch.full_like(t_ray, float("nan")))
    eps = 1e-3
    grad = torch.stack([sdf(p_hit + p_hit.new_tensor(e)) - sdf(p_hit - p_hit.new_tensor(e))
                        for e in ([eps, 0, 0], [0, eps, 0], [0, 0, eps])], -1)
    n = grad / torch.clamp_min(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), 1e-9)
    light = p_hit.new_tensor([0.4, 0.8, 0.45])
    shade = 0.35 + 0.65 * torch.clamp_min(n @ (light / torch.linalg.vector_norm(light)), 0.0)
    rgb = albedo(p_hit) * shade[..., None]
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    return rgb, depth


def kinect_noise(depth: torch.Tensor, gen: torch.Generator, sigma0: float, k: float,
                 z0: float) -> torch.Tensor:
    """Axial depth noise sigma(z) = sigma0 + k (z - z0)^2 (Nguyen, Izadi and
    Lovell, 3DIMPVT 2012), one draw per pixel from ``gen``; NaN stays NaN."""
    noise = torch.randn(depth.shape, generator=gen, device=depth.device, dtype=depth.dtype)
    return depth + noise * (sigma0 + k * (depth - z0) ** 2)


def look_at(source: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world 4x4 (float64): z toward the target, x = z cross up."""
    z = target - source
    z = z / np.linalg.norm(z)
    up = up / np.linalg.norm(up)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, :3] = np.column_stack([x, y, z])
    T[:3, 3] = source
    return T


def trajectory(spec: dict) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses of a trajectory spec.

    ``orbit``: a = start + span i / (n - 1); the camera at center +
    (radius sin a + offset[0], offset[1] + bob[0] sin(bob[1] a),
    radius cos a + offset[2]), looking at the centre.
    ``lemniscate``: th = 2 pi i / (n - 1); the camera at (amp[0] sin 2th,
    height[0] + height[1] sin(height[2] th), amp[1] sin th), looking at the
    point ``lead`` radians ahead, ``drop`` metres lower.
    """
    n = int(spec["n_frames"])
    up = np.asarray(spec.get("up", [0.0, -1.0, 0.0]), np.float64)
    out = []
    if spec["kind"] == "orbit":
        c = np.asarray(spec["center"], np.float64)
        off, bob = spec["offset"], spec["bob"]
        for i in range(n):
            a = spec["start"] + spec["span"] * i / max(n - 1, 1)
            cam = c + np.array([spec["radius"] * math.sin(a) + off[0],
                                off[1] + bob[0] * math.sin(bob[1] * a),
                                spec["radius"] * math.cos(a) + off[2]])
            out.append(look_at(cam, c, up))
    elif spec["kind"] == "lemniscate":
        amp, h = spec["amp"], spec["height"]

        def pos(a):
            return np.array([amp[0] * math.sin(2 * a), h[0] + h[1] * math.sin(h[2] * a),
                             amp[1] * math.sin(a)])

        for i in range(n):
            th = 2.0 * math.pi * i / max(n - 1, 1)
            target = pos(th + spec["lead"])
            target[1] -= spec["drop"]
            out.append(look_at(pos(th), target, up))
    else:
        raise ValueError(f"unknown trajectory kind {spec['kind']!r}")
    return np.stack(out)


def cycle_order(n_frames: int, mode: str) -> list:
    """The frame index of each step of one cycle: ``pingpong`` plays the
    trajectory forward and back (2 n - 2 steps, no frame twice in a row),
    ``loop`` plays frames 0 .. n - 2 (the last pose equals the first)."""
    if mode == "pingpong":
        return list(range(n_frames)) + list(range(n_frames - 2, 0, -1))
    if mode == "loop":
        return list(range(n_frames - 1))
    raise ValueError(f"unknown cycle mode {mode!r}")
