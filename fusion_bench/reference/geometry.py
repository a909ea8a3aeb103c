"""SE(3) maps and voxel-grid indexing on tensors, in plain PyTorch.

A twist is xi = [rho (3), phi (3)] with exp(xi) = (exp(phi^), J_l(phi) rho).
Voxel ``i`` of a grid owns (i, i + 1] in voxel units; flat ids are
x-major, z fastest.
"""

from __future__ import annotations

import torch

from .precision import F32, Precision

_EPS = 1e-8


def hat(phi):
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def so3_exp(phi, prec: Precision = F32):
    angle2 = torch.sum(phi * phi, -1)
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < _EPS
    a = torch.where(small, 1.0 - angle2 / 6.0, torch.sin(angle) / angle)
    b = torch.where(small, 0.5 - angle2 / 24.0, (1.0 - torch.cos(angle)) / angle2)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None, None] * K + b[..., None, None] * prec.mm(K, K)


def so3_left_jacobian(phi, prec: Precision = F32):
    angle2 = torch.sum(phi * phi, -1)
    angle = torch.sqrt(torch.clamp_min(angle2, _EPS * _EPS))
    small = angle2 < _EPS
    c1 = torch.where(small, 0.5 - angle2 / 24.0, (1.0 - torch.cos(angle)) / angle2)
    c2 = torch.where(small, 1.0 / 6.0 - angle2 / 120.0,
                     (angle - torch.sin(angle)) / (angle2 * angle))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + c1[..., None, None] * K + c2[..., None, None] * prec.mm(K, K)


def se3_exp(xi, prec: Precision = F32):
    rho, phi = xi[..., :3], xi[..., 3:6]
    return so3_exp(phi, prec), prec.mm(so3_left_jacobian(phi, prec), rho[..., None])[..., 0]


def compose(Ra, ta, Rb, tb, prec: Precision = F32):
    """(Ra, ta) o (Rb, tb): b first, then a."""
    return prec.mm(Ra, Rb), prec.mm(Ra, tb[..., None])[..., 0] + ta


def transform(R, t, pts, prec: Precision = F32):
    """(R, t) applied to (N, 3) points."""
    return prec.mm(pts, R.T) + t[None, :]


def linearize(xyz, n_xyz):
    return (xyz[..., 0] * n_xyz[1] + xyz[..., 1]) * n_xyz[2] + xyz[..., 2]


def unlinearize(idx, n_xyz):
    nyz = n_xyz[1] * n_xyz[2]
    return torch.stack([idx // nyz, (idx // n_xyz[2]) % n_xyz[1], idx % n_xyz[2]], -1)


def in_bounds(grid, n_xyz):
    n = torch.as_tensor(n_xyz, dtype=grid.dtype, device=grid.device)
    return torch.all((grid >= 0) & (grid < n), -1)


def clamp_grid(grid, n_xyz):
    n = torch.as_tensor(n_xyz, dtype=grid.dtype, device=grid.device)
    return torch.minimum(torch.clamp_min(grid, 0), n - 1)


NEIGHBORS6 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def expand6(flat_ids, valid, n_xyz):
    """Each id with its 6 axis neighbours (clamped): ((7N,) ids, (7N,) valid)."""
    xyz = unlinearize(flat_ids, n_xyz)
    offs = torch.as_tensor(NEIGHBORS6, dtype=xyz.dtype, device=xyz.device)
    nb = clamp_grid(xyz[:, None, :] + offs[None], n_xyz)
    return linearize(nb, n_xyz).reshape(-1), valid[:, None].expand(-1, 7).reshape(-1)


_BIG = torch.iinfo(torch.int64).max


def masked_unique(ids, valid, capacity: int):
    """Unique valid ids ascending in a ``capacity`` buffer: (ids, valid,
    overflow)."""
    s, _ = torch.sort(torch.where(valid, ids, torch.full_like(ids, _BIG)))
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    first &= s != _BIG
    rank = torch.cumsum(first, 0) - 1
    n = first.sum()
    out = torch.zeros(capacity + 1, dtype=ids.dtype, device=ids.device)
    out.index_copy_(0, torch.where(first & (rank < capacity), rank, capacity), s)
    uvalid = torch.arange(capacity, device=ids.device) < n
    return torch.where(uvalid, out[:capacity], 0), uvalid, n > capacity


def occurrence_count(ids, valid):
    keyed = torch.where(valid, ids, torch.full_like(ids, _BIG))
    _, inverse, counts = torch.unique(keyed, return_inverse=True, return_counts=True)
    return torch.where(valid, counts[inverse], torch.zeros_like(ids))
