"""Online fusion pipeline: sequence -> tracker -> map -> mesher (one device).

Counterpart of the JAX package's ``system/pipeline.py``: depth cut ->
track -> every ``integrate_interval`` frames transform the processed cloud
by the pose and integrate it (with ``do_optimize``, refine the latents
after) -> every ``meshing_interval`` frames re-mesh -> at the end join the
workers and extract a final full-quality mesh.  Writes the same
``trajectory.txt``, ``mesh.ply``, ``map.npz`` and ``stats.json``.

``run_async`` runs the cadence meshing and, with ``do_optimize``, the
refinement on the map's worker (``system/worker.py``: one thread and one
CUDA stream of the one card, the JAX package's second device;
``single_device: true`` means the same here).  ``mesh_fast`` is the decode mode of every extraction (the
reference's coarse decode, upsample and near-surface re-decode); the exact
full decode stays the default.

Mesh samples are decoded in f32 for every ``mesh_decode_precision``.  The
JAX package's ``default`` is a one-pass bf16 decode, so the port's mesh is
the more exact one there; the key is read and otherwise ignored.
``mesh_reuse_latent_eps`` > 0 turns on the mesher's latent-reuse gate.

``frames_per_call`` K > 1 buffers the tracking-only frames and tracks a
full buffer of K as one block (``SDFTracker.track_camera_block``); a
cadence frame, a frame that needs a set pose and the end of the run flush
the buffer first, a partial buffer frame by frame.  On the card a block is
K frames of graph replays, each with its host reads of the GN done flag,
so it is no faster than K single frames; the trajectory is the same.

``vis: true`` (with an output directory) writes a headless preview every
``vis_interval`` frames (``meshing_interval`` by default) under
``<output>/preview``: the mesh as it stands (after the async extraction,
if one runs), the trajectory so far and the voxel blocks' wireframes
(``write_preview``; its time is the ``vis_preview`` stage).

Each frame is a ``pipeline.frame`` span (``utils/trace.py``) holding one
span a layer it calls: ``tracker.track``, ``map.integrate`` and
``mesher.extract``, with the layers' own spans inside.  ``run`` keeps the
totals of the stages' spans alone (unless a capture is open already, as
``main --profile`` opens one) and builds ``stats.json``'s ``timing`` from
them: the host's seconds of each stage, which hold the device's time only
where the stage waited on the device.  ``stats.json``'s ``counters`` are
the run's: GN evaluations by group (``tracker.gn_evals.g<k>``), the
mesher's extractions and the voxels they decoded.  ``verbose_timing:
true`` logs each frame's track, integrate and mesh ms from the same spans.
"""

from __future__ import annotations

import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..utils import trace
from ..utils.evaluate import ate_rmse, mesh_abs_sdf_error, save_tum_trajectory
from .map import SparseVoxelMap
from .mesher import Mesher
from .tracker import SDFTracker

# stats.json's timing: each stage and its span
STAGES = (("track", "tracker.track"), ("integrate", "map.integrate"),
          ("mesh", "mesher.extract"), ("vis_preview", "pipeline.vis_preview"),
          ("join", "pipeline.join"), ("final_mesh", "pipeline.final_mesh"))
STAGE_SPANS = frozenset(name for _, name in STAGES)
# ``pipeline.frame``'s attributes, shared so that no frame allocates them
_CADENCE, _TRACKED = {"cadence": True}, {"cadence": False}


def stage_timing(totals: dict) -> dict:
    """Each stage that ran, from its span's (count, total ns, longest ns)."""
    out = {}
    for stage, name in STAGES:
        if name in totals:
            n, tot, longest = totals[name]
            out[stage] = {"total_s": 1e-9 * tot, "count": n, "mean_ms": 1e-6 * tot / n,
                          "max_ms": 1e-6 * longest}
    return out


class FusionPipeline:
    def __init__(self, model, args, device, point_budget: int = None):
        self.device = torch.device(device)
        self.args = args
        self.run_async = bool(getattr(args, "run_async", False))
        self.do_optimize = bool(getattr(args, "do_optimize", False))
        self.mesh_fast = bool(getattr(args, "mesh_fast", False))
        model.to(self.device)
        self.map = SparseVoxelMap(model, args.mapping, args.model.code_length,
                                  self.device)
        self.mesher = Mesher(self.map, max_n_triangles=int(
            getattr(args, "max_n_triangles", 4e6)),
            mesh_batch_budget=int(getattr(args, "mesh_batch_budget", 4096)),
            reuse_latent_eps=float(getattr(args, "mesh_reuse_latent_eps", 0.0)),
            mesh_fast=self.mesh_fast)
        budget = point_budget or int(getattr(args.mapping, "points_capacity", 16384))
        self.map.mesher = self.mesher
        self.tracker = SDFTracker(self.map, args.tracking, point_budget=budget)
        self.verbose_timing = bool(getattr(args, "verbose_timing", False))
        self.frames_per_call = int(getattr(args, "frames_per_call", 1))
        if self.frames_per_call < 1:
            raise ValueError(f"frames_per_call must be >= 1, got {self.frames_per_call}")
        self._frame_buf = []

    def flush_frames(self):
        """Track the buffered frames: a full buffer as one block, a partial
        one frame by frame."""
        buf, self._frame_buf = self._frame_buf, []
        if not buf:
            return
        depth_cut = (self.args.depth_cut_min, self.args.depth_cut_max)
        with trace.span("tracker.track"):
            if len(buf) == self.frames_per_call:
                def stack(arrs):
                    return torch.stack([torch.as_tensor(a, device=self.device) for a in arrs])

                self.tracker.track_camera_block(stack([f.rgb for f in buf]),
                                                stack([f.depth for f in buf]), buf[0].calib,
                                                depth_cut=depth_cut)
            else:
                for f in buf:
                    self.tracker.track_camera(f.rgb, f.depth, f.calib, depth_cut=depth_cut)

    def process_frame(self, frame, frame_id: int, use_gt_pose: bool = False):
        """One frame through the pipeline; returns the device pose (R, t), or
        None for a frame buffered for a block (``frames_per_call`` > 1)."""
        is_cadence = (frame_id % self.args.integrate_interval == 0
                      or frame_id % self.args.meshing_interval == 0)
        with trace.span("pipeline.frame", frame=frame_id,
                        attrs=_CADENCE if is_cadence else _TRACKED):
            return self._process_frame(frame, frame_id, use_gt_pose, is_cadence)

    def _process_frame(self, frame, frame_id: int, use_gt_pose: bool, is_cadence: bool):
        if self.frames_per_call > 1 and not (is_cadence or frame_id == 0 or use_gt_pose):
            self._frame_buf.append(frame)
            if len(self._frame_buf) == self.frames_per_call:
                self.flush_frames()
            return None
        self.flush_frames()
        depth_cut = (self.args.depth_cut_min, self.args.depth_cut_max)
        set_pose = None
        if frame_id == 0:
            set_pose = frame.gt_pose if (use_gt_pose and frame.gt_pose is not None) \
                else getattr(self.args, "first_iso", None) or frame.gt_pose
        elif use_gt_pose:
            set_pose = frame.gt_pose

        with trace.span("tracker.track") as sp:
            pose = self.tracker.track_camera(frame.rgb, frame.depth, frame.calib,
                                             set_pose=set_pose, depth_cut=depth_cut)
        self._log_stage(frame_id, "track", sp)

        if frame_id % self.args.integrate_interval == 0:
            pts, nrm, mask = self.tracker.last_processed_pc
            with trace.span("map.integrate") as sp:
                self.map.integrate_keyframe(pts, nrm, valid=mask, pose=pose,
                                            do_optimize=self.do_optimize,
                                            async_optimize=self.run_async)
            self._log_stage(frame_id, "integrate", sp)
        if frame_id % self.args.meshing_interval == 0:
            # the fetch is deferred to the next read of the mesh (sync), or
            # the worker fetches (async)
            with trace.span("mesher.extract") as sp:
                self.mesher.extract(self.args.resolution,
                                    max_std=getattr(self.args, "max_std", 0.15),
                                    extract_async=self.run_async, materialize=False)
            self._log_stage(frame_id, "mesh", sp)
        return pose

    def _log_stage(self, frame_id: int, stage: str, sp):
        """With ``verbose_timing``, log the stage's span in host ms (the
        enqueue, unless the stage waited on the device) when it was recorded."""
        if self.verbose_timing and sp is not trace.NOOP:
            logging.info("frame %d %s %.2f ms", frame_id, stage, sp.ms)

    def trajectory(self):
        return self.tracker.pose_history()

    def write_preview(self, preview_dir, frame_id: int):
        """The headless preview of frame ``frame_id``: ``mesh_<id>.ply`` (the
        mesher's triangles, after its async extraction if one runs),
        ``trajectory_<id>.txt`` (TUM, every frame so far) and
        ``blocks_<id>.ply`` (the allocated voxels' wireframes and the map's
        bound as a PLY with edges).  Each reads the device on the host."""
        from ..utils import vis

        preview_dir = Path(preview_dir)
        preview_dir.mkdir(parents=True, exist_ok=True)
        self.mesher.save_ply(preview_dir / f"mesh_{frame_id:05d}.ply")
        save_tum_trajectory(preview_dir / f"trajectory_{frame_id:05d}.txt", self.trajectory())
        vis.save_lineset_ply(preview_dir / f"blocks_{frame_id:05d}.ply",
                             self.map.get_fast_preview_visuals()[0])

    def run(self, sequence, use_gt_pose: bool = False, max_frames: int = None,
            output_dir=None):
        n = len(sequence) if max_frames is None else min(max_frames, len(sequence))
        vis_on = bool(getattr(self.args, "vis", False)) and output_dir is not None
        vis_interval = int(getattr(self.args, "vis_interval", None)
                           or self.args.meshing_interval)
        open_cap = trace.active()
        with (contextlib.nullcontext(open_cap) if open_cap is not None
              else trace.capture(summary=STAGE_SPANS)) as cap:
            for i in range(n):
                with trace.span("pipeline.read"):
                    frame = next(sequence)
                logging.info("Frame ID = %d", i)
                self.process_frame(frame, i, use_gt_pose=use_gt_pose)
                if vis_on and i % vis_interval == 0 and i > 0:
                    with trace.span("pipeline.vis_preview"):
                        self.write_preview(Path(output_dir) / "preview", i)
            self.flush_frames()
            with trace.span("pipeline.join"):
                self.mesher.join_async()
                self.map.join_refiner()
            with trace.span("pipeline.final_mesh"):
                self.mesher.extract(self.args.resolution,
                                    max_std=getattr(self.args, "max_std", 0.15))
            timing, counters = stage_timing(cap.totals()), dict(cap.counters)
        poses = self.trajectory()
        results = {"n_frames": n, "timing": timing, "counters": counters}
        if self.tracker.drop_fracs:
            drops = torch.cat([d.reshape(-1) for d in self.tracker.drop_fracs]).cpu().numpy()
            results["box_filter_drop_frac"] = {
                "mean": float(drops.mean()), "max": float(drops.max())}
            if drops.max() > 0.05:
                logging.warning(
                    "box-filter drop rate peaked at %.1f%% (>5%%): raise "
                    "mapping.points_capacity (the exact filter) or the hash "
                    "filter's table_bits", 100 * drops.max())
        results["map"] = {"n_occupied": int(self.map.state.n_occupied),
                          "overflow": bool(self.map.state.overflow)}
        if sequence.gt_trajectory is not None and not use_gt_pose:
            results["ate_rmse"] = ate_rmse(poses, sequence.gt_trajectory[:n])
        gt_sdf = getattr(sequence, "scene_sdf", None)
        if gt_sdf is not None:
            err = mesh_abs_sdf_error(self.mesher.current_mesh(), gt_sdf,
                                     device=self.device)
            if not np.isnan(err):
                results["mesh_abs_sdf"] = err
        results["n_triangles"] = int(len(self.mesher.current_mesh()))
        if self.mesher.reuse_latent_eps > 0.0:
            results["mesh_reuse"] = self.mesher.reuse_stats()
        if self.map.refine_log:
            results["refine"] = self.map.refine_summary()
            results["refine_merged"] = self.map.refine_merged
        if self.run_async:
            results["async_mesh"] = {"started": self.mesher.async_started,
                                     "returned": self.mesher.async_returned}
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            save_tum_trajectory(output_dir / "trajectory.txt", poses)
            self.mesher.save_ply(output_dir / "mesh.ply")
            self.map.save(output_dir / "map.npz")
            with (output_dir / "stats.json").open("w") as f:
                json.dump(results, f, indent=2)
        return results
