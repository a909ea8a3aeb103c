"""SO(3)/SE(3) maps on tensors for the device-side tracker.

Conventions match ``utils.se3``: a twist is ``xi = [rho(3), phi(3)]`` and
``exp(xi) = (R = exp(phi^), t = J_l(phi) rho)``.  Branch-free (Taylor
fallbacks through ``torch.where``), so a pose update never leaves the
device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric wedge."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye_like(phi):
    return torch.eye(3, dtype=phi.dtype, device=phi.device)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) Rodrigues' rotation, Taylor fallback near 0."""
    angle2 = torch.sum(phi * phi, dim=-1)
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < _EPS
    sin_by_a = torch.where(small, 1.0 - angle2 / 6.0, torch.sin(angle) / angle)
    omc_by_a2 = torch.where(small, 0.5 - angle2 / 24.0,
                            (1.0 - torch.cos(angle)) / angle2)
    K = hat(phi)
    return _eye_like(phi) + sin_by_a[..., None, None] * K \
        + omc_by_a2[..., None, None] * (K @ K)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) left Jacobian of SO(3)."""
    angle2 = torch.sum(phi * phi, dim=-1)
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < _EPS
    c1 = torch.where(small, 0.5 - angle2 / 24.0, (1.0 - torch.cos(angle)) / angle2)
    c2 = torch.where(small, 1.0 / 6.0 - angle2 / 120.0,
                     (angle - torch.sin(angle)) / (angle2 * angle))
    K = hat(phi)
    return _eye_like(phi) + c1[..., None, None] * K + c2[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor):
    """Twist (..., 6) -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3); for angles well below pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_angle = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    vee = 0.5 * torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    small = angle < 1e-5
    scale = torch.where(small, 1.0 + angle * angle / 6.0, angle / torch.sin(angle))
    return vee * scale[..., None]


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def transform_points(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to (N, 3) points."""
    return pts @ R.T + t[None, :]
