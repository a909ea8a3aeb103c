"""Per-scene training: fit the encoder-decoder prior from an RGB-D sequence.

Counterpart of the JAX package's ``trainer/scene.py`` (the capability that
the reference's ``yc_trainer.py`` and ``configs/train_scannet.yaml``
describe):

  1. every ``frame_stride``-th frame of a sequence with ground-truth poses
     goes through the frontend on the device (``preprocess_frame``: the
     ``stencil_frontend`` kernel, then the exact box filter into
     ``point_budget`` points);
  2. the oriented points, moved to the world frame with the frame's pose,
     are jittered along their normals (the jitter is the SDF target) and
     split per voxel into LIFs with the offline generator's bucketing and
     filters (``data.generator.split_lifs``);
  3. the joint trainer runs on them as an in-memory dataset.

The jitter is drawn from ``np.random.RandomState(seed)`` in the JAX
package's order, so one seed gives both packages the same LIFs.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..data.generator import split_lifs
from ..data.lif_dataset import LifDataset
from ..system.frontend import preprocess_frame
from . import train as trainer_mod


class MemoryLifDataset(LifDataset):
    """``LifDataset`` over in-memory payload dicts: no backing directory,
    so ``sample_batch`` packs the pools in RAM."""

    def __init__(self, payloads, num_sample, num_surface_sample=128,
                 augment_rotation=None, augment_noise=(0.0, 0.0), seed=0):
        self.payloads = payloads
        self.data_path = None
        self.data_sources = list(range(len(payloads)))
        self.num_sample = num_sample
        self.num_surface_sample = num_surface_sample
        self.augment_rotation = augment_rotation
        self.augment_noise = augment_noise
        self.rng = np.random.RandomState(seed)
        self._cache = None

    def get_raw_data(self, idx):
        return self.payloads[idx]


class Harvest(NamedTuple):
    lifs: list               # payload dicts: min, max, data (N, 4), surface (M, 6)
    keyframes: int
    points: int              # world-frame surface points over all keyframes
    drop_frac: np.ndarray    # (keyframes,) share of points the box filter dropped
    seconds: float


def preprocess_kwargs(args) -> dict:
    """The frontend's metric thresholds from a top-level ``preprocess:``
    block, else ``tracking['preprocess']`` (the reference's VGA defaults
    where neither gives one): ``int`` for the ``*_nb`` counts, ``float``
    for the rest."""
    tracking = getattr(args, "tracking", None)
    pre = (getattr(args, "preprocess", None)
           or (tracking.get("preprocess") if isinstance(tracking, dict) else None)
           or {})
    if not isinstance(pre, dict):
        pre = vars(pre)
    keys = ("outlier_radius", "outlier_min_nb", "normal_radius", "normal_min_nb",
            "box_filter_size")
    return {k: (int(pre[k]) if k.endswith("_nb") else float(pre[k]))
            for k in keys if k in pre}


def harvest_scene_lifs(sequence, args, max_frames=None, frame_stride=5,
                       point_budget=32768, jitter=0.3, seed=0, device="cuda") -> Harvest:
    """Stream ``sequence`` (frames on the host or on ``device``) -> LIFs.

    Each keyframe's masked points and normals come to the host in one
    copy; the box filter's drop fractions stay on the device until the
    end.  Raises on a frame without a pose."""
    device = torch.device(device)
    t0 = time.perf_counter()
    mapping = args.mapping
    voxel = float(mapping["voxel_size"] if isinstance(mapping, dict) else mapping.voxel_size)
    depth_cut = (getattr(args, "depth_cut_min", 0.5), getattr(args, "depth_cut_max", 5.0))
    pre_kw = preprocess_kwargs(args)
    all_pts, all_nrm, drops = [], [], []
    n = len(sequence) if max_frames is None else min(max_frames, len(sequence))
    for i in range(n):
        frame = next(sequence)
        if i % frame_stride != 0:
            continue
        pose = frame.gt_pose
        if pose is None:
            raise ValueError("per-scene training needs sequence poses (load_gt)")
        c = frame.calib
        pre = preprocess_frame(torch.as_tensor(frame.rgb, device=device),
                               torch.as_tensor(frame.depth, device=device),
                               c.fx, c.fy, c.cx, c.cy, depth_cut[0], depth_cut[1],
                               point_budget, depth_scale=float(getattr(c, "dscale", 1.0)),
                               **pre_kw)
        drops.append(pre.drop_frac)
        host = torch.cat([pre.points, pre.normals], 1)[pre.mask].cpu().numpy()
        R = pose.q.rotation_matrix
        all_pts.append(host[:, :3] @ R.T + pose.t)
        all_nrm.append(host[:, 3:] @ R.T)
    pts = np.concatenate(all_pts).astype(np.float32)
    nrm = np.concatenate(all_nrm).astype(np.float32)
    drop = torch.stack(drops).cpu().numpy()
    logging.info("scene harvest: %d surface points from %d keyframes (box-filter drop "
                 "max %.4f)", len(pts), len(all_pts), float(drop.max()))

    # SDF queries: jitter along the normals at two scales; the jitter is the target
    rng = np.random.RandomState(seed)
    reps = 4
    base = np.repeat(pts, reps, axis=0)
    base_n = np.repeat(nrm, reps, axis=0)
    scale = np.where(rng.rand(len(base), 1) < 0.5, jitter * voxel, jitter * voxel / 5.0)
    s = rng.randn(len(base), 1) * scale
    data_arr = np.concatenate([base + s * base_n, s], axis=1).astype(np.float32)
    surface_arr = np.concatenate([pts, nrm], axis=1).astype(np.float32)
    lifs = split_lifs(data_arr, surface_arr, voxel)
    return Harvest(lifs, len(all_pts), len(pts), drop, time.perf_counter() - t0)


def train_scene(args, sequence, max_frames=None, max_steps_per_epoch=None,
                device="cuda", dp: bool = False, step_hook=None):
    """Harvest ``sequence`` and run the joint trainer on it.  Returns
    (model, save_dir); the harvest's counts go to ``harvest.json`` in the
    run directory (from rank 0 under data parallelism)."""
    harvest = harvest_scene_lifs(sequence, args, max_frames=max_frames, device=device)
    logging.info("scene harvest: %d LIF voxels in %.2f s", len(harvest.lifs), harvest.seconds)
    if not harvest.lifs:
        raise RuntimeError("no LIFs harvested — check depth range / poses")
    train_spec = args.train_set[0] if getattr(args, "train_set", None) else {}
    dataset = MemoryLifDataset(
        harvest.lifs, num_sample=args.samples_per_lif,
        num_surface_sample=int(train_spec.get("num_surface_sample", 128)),
        augment_rotation=train_spec.get("augment_rotation"),
        augment_noise=tuple(train_spec.get("augment_noise", (0.0, 0.0))))
    model, save_dir = trainer_mod.train(args, max_steps_per_epoch=max_steps_per_epoch,
                                        dataset=dataset, device=device, dp=dp,
                                        step_hook=step_hook)
    if not dp or torch.distributed.get_rank() == 0:
        (Path(save_dir) / "harvest.json").write_text(json.dumps(dict(
            keyframes=harvest.keyframes, points=harvest.points, lifs=len(harvest.lifs),
            drop_frac=harvest.drop_frac.tolist(), seconds=harvest.seconds)))
    return model, save_dir
