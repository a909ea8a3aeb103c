"""Device-resident LIF training data: the packed pools live on the card.

Counterpart of the JAX package's ``data/device_lif.py``.  The host path
(``LifDataset.sample_batch``) assembles each batch in numpy and copies
about 4.4 MB a step to the card; here the packed pools are copied once and
every batch is drawn and augmented on the card from a ``torch.Generator``
on the device.  The step's only host input is the epoch's permutation,
copied once per epoch.

The draws follow ``LifDataset.sample_batch``'s distributions (balanced
+/- pools, uniform row choice within a LIF, Y / X / Z / 3D rotation,
surface noise with normal-cone perturbation); the stream is PyTorch's, so
the rows differ from the host path's and from the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _rows(arr, off, idxs, r):
    """Per-LIF rows: arr (N, C) pool, off (L + 1,) offsets, idxs (B,),
    r (B, k) uniform integer draws -> (B, k, C) rows, zeros for an empty pool."""
    starts = off[idxs][:, None]
    cnts = (off[idxs + 1] - off[idxs])[:, None]
    if arr.shape[0] == 0:
        return arr.new_zeros(r.shape + (arr.shape[1],))
    flat = (starts + r % cnts.clamp_min(1)).clamp_max(arr.shape[0] - 1)
    rows = arr[flat.reshape(-1)].reshape(r.shape + (arr.shape[1],))
    return torch.where((cnts == 0)[..., None], 0.0, rows)


def _axis_rotations(axis, deg):
    """(B,) degrees about a fixed unit axis -> (B, 3, 3) rotation matrices
    (Rodrigues: c I + (1 - c) a a^T + s [a]x), built from the angles alone:
    a tensor made from host data would cost a synchronous copy per batch."""
    th = torch.deg2rad(deg)
    c, s = torch.cos(th), torch.sin(th)
    x, y, z = axis
    t = 1 - c
    rows = [[c + t * x * x, t * x * y - s * z, t * x * z + s * y],
            [t * y * x + s * z, c + t * y * y, t * y * z - s * x],
            [t * z * x - s * y, t * z * y + s * x, c + t * z * z]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _perturb_normal(n, theta_range, gen):
    """Tilt each normal by a random angle within a cone (the device twin of
    ``lif_dataset.perturb_normal``)."""
    zero = torch.zeros_like(n[..., 0])
    nx1 = torch.stack([-n[..., 1], n[..., 0], zero], -1)
    nx2 = torch.stack([-n[..., 2], zero, n[..., 0]], -1)
    use1 = (n[..., 2].abs() - 1.0).abs() > 0.1
    nx = torch.where(use1[..., None], nx1, nx2)
    nx = nx / nx.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    ny = torch.linalg.cross(n, nx)
    shape = n.shape[:-1] + (1,)
    phi = torch.rand(shape, generator=gen, device=n.device) * (2 * math.pi)
    theta = torch.rand(shape, generator=gen, device=n.device) * theta_range
    return torch.cos(theta) * n + torch.sin(theta) * (torch.cos(phi) * nx + torch.sin(phi) * ny)


class DeviceLifDataset:
    """The packed pools of one ``LifDataset`` on a device; ``sample(idxs,
    gen)`` draws a batch there."""

    def __init__(self, base, device):
        pk = base._ensure_packed()
        dev = torch.device(device)
        # np.array copies: the packed pools are read-only memory maps
        f32 = lambda x: torch.from_numpy(np.array(x, np.float32)).to(dev)
        i64 = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(dev)
        self.pos, self.neg, self.surf = f32(pk["pos"]), f32(pk["neg"]), f32(pk["surf"])
        self.pos_off, self.neg_off = i64(pk["pos_off"]), i64(pk["neg_off"])
        self.surf_off = i64(pk["surf_off"])
        self.half = int(base.num_sample // 2)
        self.M = int(base.num_surface_sample)
        self.aug_mode = base.augment_rotation
        self.noise_sigma = float(base.augment_noise[0])
        self.noise_theta = float(np.deg2rad(base.augment_noise[1]))
        self.n = len(base)
        self.device = dev
        self.nbytes = sum(t.numel() * t.element_size() for t in (self.pos, self.neg, self.surf))

    def __len__(self):
        return self.n

    @staticmethod
    def from_dataset(dataset, device):
        """Wrap a LifDataset (or a combined dataset of one member)."""
        if hasattr(dataset, "datasets"):
            if len(dataset.datasets) != 1:
                raise ValueError(
                    "device-resident sampling supports one dataset "
                    f"(got {len(dataset.datasets)}); pools with different "
                    "augment configs cannot share one sampler")
            dataset = dataset.datasets[0]
        if not hasattr(dataset, "_ensure_packed"):
            raise ValueError("dataset has no packed layout")
        return DeviceLifDataset(dataset, device)

    def sample(self, idxs: torch.Tensor, gen: torch.Generator):
        """(B,) LIF indices on the device -> (sdf (B, S, 4), surface (B, M, 6))."""
        dev, B = self.device, idxs.shape[0]
        randint = lambda k: torch.randint(0, 1 << 30, (B, k), generator=gen, device=dev)
        samples = torch.cat([_rows(self.pos, self.pos_off, idxs, randint(self.half)),
                             _rows(self.neg, self.neg_off, idxs, randint(self.half))], 1)
        sf = _rows(self.surf, self.surf_off, idxs, randint(self.M))

        if self.aug_mode is not None:
            if self.aug_mode == "3D":
                g = torch.randn((B, 3, 3), generator=gen, device=dev)
                q, _ = torch.linalg.qr(g)
                flip = torch.where(torch.linalg.det(q) < 0, -1.0, 1.0)
                R = torch.cat([q[:, :, :1] * flip[:, None, None], q[:, :, 1:]], 2)
            else:
                u = torch.rand((B,), generator=gen, device=dev)
                if self.aug_mode == "Y":
                    base = torch.randint(0, 4, (B,), generator=gen, device=dev) * 90.0
                    R = _axis_rotations([0.0, 1.0, 0.0], base + 30.0 * u)
                elif self.aug_mode == "X":
                    R = _axis_rotations([1.0, 0.0, 0.0], 360.0 * u)
                else:
                    R = _axis_rotations([0.0, 0.0, 1.0], 360.0 * u)
            Rt = R.transpose(1, 2)
            samples = torch.cat([samples[..., :3] @ Rt, samples[..., 3:]], -1)
            sf = torch.cat([sf[..., :3] @ Rt, sf[..., 3:6] @ Rt], -1)

        if self.noise_sigma > 0:
            noise = torch.randn(sf[..., :3].shape, generator=gen, device=dev)
            sf = torch.cat([sf[..., :3] + self.noise_sigma * noise,
                            _perturb_normal(sf[..., 3:6], self.noise_theta, gen)], -1)
        return samples, sf
