"""Online fusion pipeline: sequence -> tracker -> map -> mesher (one device).

Counterpart of the JAX package's ``system/pipeline.py`` for the sync path:
depth cut -> track -> every ``integrate_interval`` frames transform the
processed cloud by the pose and integrate it -> every
``meshing_interval`` frames re-mesh -> a final full-quality mesh.  Writes
the same ``trajectory.txt``, ``mesh.ply``, ``map.npz`` and ``stats.json``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..utils.evaluate import ate_rmse, mesh_abs_sdf_error, save_tum_trajectory
from ..utils.meters import StageTimer
from .map import SparseVoxelMap
from .mesher import Mesher
from .tracker import SDFTracker


class FusionPipeline:
    def __init__(self, model, args, device, point_budget: int = None):
        self.device = torch.device(device)
        self.args = args
        for name in ("run_async", "do_optimize", "mesh_fast"):
            if bool(getattr(args, name, False)):
                raise NotImplementedError(f"{name}: true is not ported yet")
        if int(getattr(args, "frames_per_call", 1)) != 1:
            raise NotImplementedError("frames_per_call > 1 is not ported yet")
        if float(getattr(args, "mesh_reuse_latent_eps", 0.0)) > 0.0:
            raise NotImplementedError("mesh_reuse_latent_eps > 0 is not ported yet")
        model.to(self.device)
        self.map = SparseVoxelMap(model, args.mapping, args.model.code_length,
                                  self.device)
        self.mesher = Mesher(self.map, max_n_triangles=int(
            getattr(args, "max_n_triangles", 4e6)),
            mesh_batch_budget=int(getattr(args, "mesh_batch_budget", 4096)))
        budget = point_budget or int(getattr(args.mapping, "points_capacity", 16384))
        self.tracker = SDFTracker(self.map, args.tracking, point_budget=budget)
        self.timer = StageTimer()

    def process_frame(self, frame, frame_id: int, use_gt_pose: bool = False):
        """One frame through the pipeline; returns the device pose (R, t)."""
        depth_cut = (self.args.depth_cut_min, self.args.depth_cut_max)
        set_pose = None
        if frame_id == 0:
            set_pose = frame.gt_pose if (use_gt_pose and frame.gt_pose is not None) \
                else getattr(self.args, "first_iso", None) or frame.gt_pose
        elif use_gt_pose:
            set_pose = frame.gt_pose

        self.timer.start("track")
        pose = self.tracker.track_camera(frame.rgb, frame.depth, frame.calib,
                                         set_pose=set_pose, depth_cut=depth_cut)
        self.timer.stop("track")

        if frame_id % self.args.integrate_interval == 0:
            pts, nrm, mask = self.tracker.last_processed_pc
            self.timer.start("integrate")
            self.map.integrate_keyframe(pts, nrm, valid=mask, pose=pose)
            self.timer.stop("integrate")
        if frame_id % self.args.meshing_interval == 0:
            self.timer.start("mesh")
            # the fetch is deferred to the next read of the mesh
            self.mesher.extract(self.args.resolution,
                                max_std=getattr(self.args, "max_std", 0.15),
                                materialize=False)
            self.timer.stop("mesh")
        return pose

    def trajectory(self):
        return self.tracker.pose_history()

    def run(self, sequence, use_gt_pose: bool = False, max_frames: int = None,
            output_dir=None):
        n = len(sequence) if max_frames is None else min(max_frames, len(sequence))
        for i in range(n):
            frame = next(sequence)
            logging.info("Frame ID = %d", i)
            self.process_frame(frame, i, use_gt_pose=use_gt_pose)
        with self.timer.scope("final_mesh"):
            self.mesher.extract(self.args.resolution,
                                max_std=getattr(self.args, "max_std", 0.15))
        poses = self.trajectory()
        results = {"n_frames": n, "timing": self.timer.summary()}
        if self.tracker.drop_fracs:
            drops = torch.stack(self.tracker.drop_fracs).cpu().numpy()
            results["box_filter_drop_frac"] = {
                "mean": float(drops.mean()), "max": float(drops.max())}
        if sequence.gt_trajectory is not None and not use_gt_pose:
            results["ate_rmse"] = ate_rmse(poses, sequence.gt_trajectory[:n])
        gt_sdf = getattr(sequence, "scene_sdf", None)
        if gt_sdf is not None:
            err = mesh_abs_sdf_error(self.mesher.current_mesh(), gt_sdf,
                                     device=self.device)
            if not np.isnan(err):
                results["mesh_abs_sdf"] = err
        results["n_triangles"] = int(len(self.mesher.current_mesh()))
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            save_tum_trajectory(output_dir / "trajectory.txt", poses)
            self.mesher.save_ply(output_dir / "mesh.ply")
            self.map.save(output_dir / "map.npz")
            with (output_dir / "stats.json").open("w") as f:
                json.dump(results, f, indent=2)
        return results
