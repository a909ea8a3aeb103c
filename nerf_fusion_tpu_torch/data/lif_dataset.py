"""LIF (local implicit function) training dataset.

Counterpart of the JAX package's ``data/lif_dataset.py`` (the reference's
``dataset/training/lif_dataset.py``): npz payloads of per-voxel SDF
samples + oriented surface points, balanced +/- SDF subsampling, rotation
augmentation (3D/X/Y/Z modes), surface noise with normal cone
perturbation.  Host-side numpy; ``sample_batch`` draws a whole batch from
the packed pools in a few vectorised calls, with the JAX package's
numpy draws, so one seed gives the same batches in both packages.
``data/device_lif.py`` samples on the card instead.

``LifCombinedDataset`` returns the flat (samples, surface, idx) item.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np


def _rotation_matrix(axis, degrees):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return c * np.eye(3) + (1 - c) * np.outer(a, a) + s * K


def _random_rotation(rng):
    # uniform via QR of gaussian
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def perturb_normal(normals, theta_range, rng):
    """Tilt each normal by a random angle within a cone (lif_dataset.py:10-24)."""
    nx1 = np.stack([-normals[:, 1], normals[:, 0], np.zeros_like(normals[:, 0])], 1)
    nx2 = np.stack([-normals[:, 2], np.zeros_like(normals[:, 0]), normals[:, 0]], 1)
    use1 = np.abs(np.abs(normals[:, 2]) - 1.0) > 0.1
    nx = np.where(use1[:, None], nx1, nx2)
    nx = nx / np.maximum(np.linalg.norm(nx, axis=1, keepdims=True), 1e-12)
    ny = np.cross(normals, nx)
    phi = rng.rand(len(normals), 1) * 2 * np.pi
    phi_dir = np.cos(phi) * nx + np.sin(phi) * ny
    theta = rng.rand(len(normals), 1) * theta_range
    return np.cos(theta) * normals + np.sin(theta) * phi_dir


def _split_signs(data):
    """The balanced-sampling sign convention, in ONE place: positive pool
    is sdf > 0, negative pool is sdf <= 0 (reference lif_dataset.py:59-67).
    Used by the itemwise path, the in-memory pack, and the disk pack."""
    sign = data[:, 3] > 0
    return data[sign], data[~sign]


class LifDataset:
    def __init__(self, data_path, num_sample, num_surface_sample: int = 0,
                 augment_rotation=None, augment_noise=(0.0, 0.0), seed: int = 0,
                 surface_format: str = "xyzn", cache_in_ram: bool = True):
        self.data_path = Path(data_path)
        with (self.data_path / "source.json").open() as f:
            self.data_sources = json.load(f)
        self.num_sample = num_sample
        self.num_surface_sample = num_surface_sample
        self.augment_rotation = augment_rotation
        self.augment_noise = augment_noise
        self.rng = np.random.RandomState(seed)
        # Payloads are ~20 KB each; caching removes the per-item npz parse
        # that otherwise bottlenecks training on few-core hosts.
        self._cache = {} if cache_in_ram else None

    def __len__(self):
        return len(self.data_sources)

    def get_raw_data(self, idx):
        if self._cache is not None:
            if idx not in self._cache:
                with np.load(self.data_path / "payload" / ("%08d.npz" % idx)) as d:
                    self._cache[idx] = {k: d[k] for k in d.files}
            return self._cache[idx]
        return np.load(self.data_path / "payload" / ("%08d.npz" % idx))

    def __getitem__(self, idx):
        raw = self.get_raw_data(idx)
        data = raw["data"]                     # (N, 4) xyz + sdf
        surface = raw["surface"]               # (M, 6) xyz + normal
        rng = self.rng

        pos, neg = _split_signs(data)
        half = self.num_sample // 2
        samples = np.concatenate([
            pos[rng.randint(0, max(len(pos), 1), half)] if len(pos) else
            np.zeros((half, 4), np.float32),
            neg[rng.randint(0, max(len(neg), 1), half)] if len(neg) else
            np.zeros((half, 4), np.float32),
        ]).astype(np.float32)

        surf = surface[rng.choice(len(surface), self.num_surface_sample,
                                  replace=True)].astype(np.float32)

        if self.augment_rotation is not None:
            mode = self.augment_rotation
            if mode == "3D":
                R = _random_rotation(rng)
            elif mode == "X":
                R = _rotation_matrix([1.0, 0, 0], 360.0 * rng.rand())
            elif mode == "Y":
                base = random.choice([0.0, 90.0, 180.0, 270.0])
                R = _rotation_matrix([0, 1.0, 0], base + 30.0 * rng.rand())
            else:
                R = _rotation_matrix([0, 0, 1.0], 360.0 * rng.rand())
            R = R.astype(np.float32)
            samples[:, :3] = samples[:, :3] @ R.T
            surf[:, :3] = surf[:, :3] @ R.T
            surf[:, 3:6] = surf[:, 3:6] @ R.T

        if self.augment_noise[0] > 0:
            surf[:, :3] += (rng.randn(len(surf), 3) * self.augment_noise[0]).astype(np.float32)
            surf[:, 3:6] = perturb_normal(surf[:, 3:6],
                                          np.deg2rad(self.augment_noise[1]), rng)
        return samples, surf, idx


    # -- packed fast path ---------------------------------------------------
    def _ensure_packed(self):
        """Build (once) and mmap the packed layout: per-LIF sign-sorted SDF
        pools and surface rows as three concatenated .npy files + offsets.

        Vectorised batch sampling over these (``sample_batch``) replaces
        the per-item npz/python path.  The pack is persisted next to the payload and reused across runs;
        mmap keeps resident memory at the touched pages only.
        """
        if getattr(self, "_packed", None) is not None:
            return self._packed
        if getattr(self, "data_path", None) is None:
            # In-memory payload datasets (scene harvest): pack in RAM.
            pos_l, neg_l, surf_l = [], [], []
            for i in range(len(self)):
                raw = self.get_raw_data(i)
                p, ng = _split_signs(raw["data"])
                pos_l.append(np.asarray(p, np.float32))
                neg_l.append(np.asarray(ng, np.float32))
                surf_l.append(np.asarray(raw["surface"], np.float32))
            off = lambda xs: np.concatenate(
                [[0], np.cumsum([len(x) for x in xs])])
            cat = lambda xs, w: (np.concatenate(xs) if xs
                                 else np.zeros((0, w), np.float32))
            self._packed = dict(
                pos=cat(pos_l, 4), neg=cat(neg_l, 4), surf=cat(surf_l, 6),
                pos_off=off(pos_l), neg_off=off(neg_l), surf_off=off(surf_l))
            return self._packed
        pdir = self.data_path / "packed"
        meta_p = pdir / "meta.npz"
        if not meta_p.exists():
            pdir.mkdir(exist_ok=True)
            n = len(self)
            pos_cnt = np.zeros(n, np.int64)
            neg_cnt = np.zeros(n, np.int64)
            surf_cnt = np.zeros(n, np.int64)
            # Two streaming passes (count, then write) keep peak memory at
            # one payload instead of the whole uncompressed dataset.
            for i in range(n):
                with np.load(self.data_path / "payload" / ("%08d.npz" % i)) as raw:
                    p, ng = _split_signs(raw["data"])
                    surf_cnt[i] = len(raw["surface"])
                pos_cnt[i] = len(p)
                neg_cnt[i] = len(ng)
            pos_off = np.concatenate([[0], np.cumsum(pos_cnt)])
            neg_off = np.concatenate([[0], np.cumsum(neg_cnt)])
            surf_off = np.concatenate([[0], np.cumsum(surf_cnt)])
            pos_m = np.lib.format.open_memmap(
                pdir / "pos.npy", mode="w+", dtype=np.float32,
                shape=(int(pos_off[-1]), 4))
            neg_m = np.lib.format.open_memmap(
                pdir / "neg.npy", mode="w+", dtype=np.float32,
                shape=(int(neg_off[-1]), 4))
            surf_m = np.lib.format.open_memmap(
                pdir / "surf.npy", mode="w+", dtype=np.float32,
                shape=(int(surf_off[-1]), 6))
            for i in range(n):
                with np.load(self.data_path / "payload" / ("%08d.npz" % i)) as raw:
                    p, ng = _split_signs(raw["data"])
                    pos_m[pos_off[i]:pos_off[i + 1]] = p
                    neg_m[neg_off[i]:neg_off[i + 1]] = ng
                    surf_m[surf_off[i]:surf_off[i + 1]] = raw["surface"]
            del pos_m, neg_m, surf_m
            np.savez(meta_p, pos_off=pos_off, neg_off=neg_off,
                     surf_off=surf_off)
        meta = np.load(meta_p)
        self._packed = dict(
            pos=np.load(pdir / "pos.npy", mmap_mode="r"),
            neg=np.load(pdir / "neg.npy", mmap_mode="r"),
            surf=np.load(pdir / "surf.npy", mmap_mode="r"),
            pos_off=meta["pos_off"], neg_off=meta["neg_off"],
            surf_off=meta["surf_off"])
        return self._packed

    def _batch_rotations(self, B, rng):
        mode = self.augment_rotation
        if mode == "3D":
            return np.stack([_random_rotation(rng) for _ in range(B)]) \
                .astype(np.float32)
        if mode == "Y":
            deg = rng.choice([0.0, 90.0, 180.0, 270.0], B) + 30.0 * rng.rand(B)
            axis = np.array([0.0, 1.0, 0.0])
        elif mode == "X":
            deg = 360.0 * rng.rand(B)
            axis = np.array([1.0, 0.0, 0.0])
        else:
            deg = 360.0 * rng.rand(B)
            axis = np.array([0.0, 0.0, 1.0])
        return np.stack([_rotation_matrix(axis, d) for d in deg]) \
            .astype(np.float32)

    def sample_batch(self, idxs):
        """Vectorised equivalent of stacking ``self[i] for i in idxs``:
        same sampling/augmentation distribution, one fancy-index per pool.

        :return: (sdf (B,S,4), surface (B,M,6)) float32.
        """
        pk = self._ensure_packed()
        idxs = np.asarray(idxs, np.int64)
        B = len(idxs)
        rng = self.rng
        half, M = self.num_sample // 2, self.num_surface_sample

        def pool_rows(arr, off, k):
            starts = off[idxs][:, None]                       # (B,1)
            cnts = (off[idxs + 1] - off[idxs])[:, None]       # (B,1)
            r = rng.randint(0, 1 << 31, (B, k)) % np.maximum(cnts, 1)
            # clip: a trailing empty pool has start == len(arr); its rows
            # are zero-filled below, the clip just keeps the gather legal
            flat = np.minimum(starts + r, max(len(arr) - 1, 0)).reshape(-1)
            rows = arr[flat].reshape(B, k, arr.shape[1]).astype(np.float32)
            rows[np.broadcast_to(cnts == 0, (B, k))] = 0.0    # empty pool -> zeros
            return rows

        samples = np.concatenate([pool_rows(pk["pos"], pk["pos_off"], half),
                                  pool_rows(pk["neg"], pk["neg_off"], half)],
                                 axis=1)                      # (B, S, 4)
        surf = pool_rows(pk["surf"], pk["surf_off"], M)       # (B, M, 6)

        if self.augment_rotation is not None:
            # batched BLAS matmul (einsum would fall back to naive loops)
            Rt = self._batch_rotations(B, rng).transpose(0, 2, 1)  # (B, 3, 3)
            samples[..., :3] = samples[..., :3] @ Rt
            surf[..., :3] = surf[..., :3] @ Rt
            surf[..., 3:6] = surf[..., 3:6] @ Rt
        if self.augment_noise[0] > 0:
            surf[..., :3] += (rng.randn(B, M, 3)
                              * self.augment_noise[0]).astype(np.float32)
            flat = surf.reshape(B * M, 6)
            flat[:, 3:6] = perturb_normal(
                flat[:, 3:6], np.deg2rad(self.augment_noise[1]), rng)
            surf = flat.reshape(B, M, 6)
        return samples, surf


class LifCombinedDataset:
    """Concatenation of several LifDatasets (flat item contract)."""

    def __init__(self, *datasets):
        assert datasets
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cum, idx, side="right"))
        base = 0 if d == 0 else int(self.cum[d - 1])
        samples, surf, _ = self.datasets[d][idx - base]
        return samples, surf, idx

    def sample_batch(self, idxs):
        """Vectorised batch sampling, grouped per sub-dataset."""
        idxs = np.asarray(idxs, np.int64)
        d = np.searchsorted(self.cum, idxs, side="right")
        base = np.concatenate([[0], self.cum[:-1]])
        S = self.datasets[0].num_sample
        M = self.datasets[0].num_surface_sample
        samples = np.zeros((len(idxs), S, 4), np.float32)
        surf = np.zeros((len(idxs), M, 6), np.float32)
        for di in np.unique(d):
            sel = d == di
            s, sf = self.datasets[di].sample_batch(idxs[sel] - base[di])
            samples[sel], surf[sel] = s, sf
        return samples, surf


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 0,
                   num_workers: int = None, prefetch: int = None,
                   max_batches: int = None):
    """Yield stacked (sdf (B,S,4), surface (B,M,6), idx (B,)) batches.

    ``max_batches`` ends the epoch early without assembling a batch past
    it, so the dataset's random stream, which the prefetch thread draws
    from ahead of the consumer, is the same whenever the consumer stops.

    Datasets exposing ``sample_batch`` (the packed-mmap fast path) assemble
    each batch with one vectorised call; otherwise items are stacked
    one-by-one.  ``num_workers`` > 0 additionally prepares up to
    ``prefetch`` batches ahead on a thread pool (the reference trains with
    8 DataLoader workers, trainer/main.py:68; npz decompression and numpy
    release the GIL, so threads overlap the device step without fork
    hazards next to an initialised CUDA context).  0 = synchronous.
    """
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    end = len(order) - (len(order) % batch_size) if drop_last else len(order)
    starts = list(range(0, end, batch_size))[:max_batches]

    if hasattr(dataset, "sample_batch"):
        def assemble(s):
            idxs = order[s:s + batch_size]
            sdf, surf = dataset.sample_batch(idxs)
            return sdf, surf, np.asarray(idxs)
        # vectorised path: a single overlap thread, still deterministic
        # (one consumer of the dataset rng)
        num_workers = 1 if num_workers is None else min(num_workers, 1)
    else:
        def assemble(s):
            items = [dataset[int(i)] for i in order[s:s + batch_size]]
            return (np.stack([it[0] for it in items]),
                    np.stack([it[1] for it in items]),
                    np.asarray([it[2] for it in items]))
        # itemwise path: threads > 1 interleave draws from the dataset's
        # shared rng nondeterministically — keep it opt-in
        if num_workers is None:
            num_workers = 0

    if num_workers <= 0:
        for s in starts:
            yield assemble(s)
        return

    from concurrent.futures import ThreadPoolExecutor
    from collections import deque

    depth = prefetch if prefetch is not None else 2 * num_workers
    ex = ThreadPoolExecutor(num_workers)
    try:
        q = deque(ex.submit(assemble, s) for s in starts[:depth])
        for i in range(len(starts)):
            if i + depth < len(starts):
                q.append(ex.submit(assemble, starts[i + depth]))
            yield q.popleft().result()
    finally:
        # Consumers may stop early (max_steps_per_epoch): drop queued work
        # instead of blocking an epoch boundary on ~depth stale batches.
        ex.shutdown(wait=False, cancel_futures=True)
