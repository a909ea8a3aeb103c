"""Camera-ray utilities for the image encoders and NeRF-style sampling.

Counterpart of the JAX package's ``utils/rays.py`` (the reference fork's
``trainer/encoder_util.py``).  JAX computes the rotations at
``Precision.HIGHEST``; here they are written as f32 multiply-adds, not
matrix products, so no TF32 setting can round them.
"""

from __future__ import annotations

import torch


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R @ v`` for every row vector of ``v`` (..., 3), in f32 arithmetic."""
    return (R * v[..., None, :]).sum(-1)


def gen_rays(pose_R, pose_t, width: int, height: int, fx, fy, cx, cy,
             z_near: float = 0.0, z_far: float = 0.0) -> torch.Tensor:
    """Per-pixel world rays of a pinhole camera (y-down image), the pose
    camera-to-world.  :return: (H, W, 8): origin (3), unit direction (3),
    near, far."""
    dev = pose_R.device
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    d_world = _rotate(pose_R, d_cam)
    origin = pose_t[None, None, :].expand(d_world.shape)
    nf = torch.tensor([z_near, z_far], dtype=torch.float32,
                      device=dev).expand(height, width, 2)
    return torch.cat([origin, d_world, nf], dim=-1)


def project_points(pts, pose_R, pose_t, fx, fy, cx, cy):
    """World points (N, 3) -> (uv (N, 2), z (N,), in_front (N,)); a depth
    within 1e-9 of 0 divides as 1e-9."""
    p_cam = _rotate(pose_R.T, pts - pose_t[None, :])     # R^T (p - t)
    z = p_cam[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = p_cam[:, 0] / zs * fx + cx
    v = p_cam[:, 1] / zs * fy + cy
    return torch.stack([u, v], -1), z, z > 0


def sample_along_rays(rays, n_samples: int, lindisp: bool = False):
    """``n_samples`` depths from near to far along (..., 8) rays, uniform
    in depth or, with ``lindisp``, in inverse depth.  :return: points
    (..., n_samples, 3), depths (..., n_samples)."""
    origin, dirs = rays[..., 0:3], rays[..., 3:6]
    near, far = rays[..., 6:7], rays[..., 7:8]
    t = torch.linspace(0.0, 1.0, n_samples, device=rays.device)
    if lindisp:
        z = 1.0 / (1.0 / torch.clamp_min(near, 1e-6) * (1 - t)
                   + 1.0 / torch.clamp_min(far, 1e-6) * t)
    else:
        z = near * (1 - t) + far * t
    pts = origin[..., None, :] + dirs[..., None, :] * z[..., :, None]
    return pts, z
