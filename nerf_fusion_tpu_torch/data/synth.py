"""Synthetic RGB-D sequence: a sphere-traced analytic SDF room.

Counterpart of the JAX package's ``data/synth.py`` (the "room" scene): a
procedurally textured room (floor, two walls, a sphere, a box) rendered
along a smooth orbit with known poses, so the whole loop (tracking,
fusion, meshing, ATE and mesh |SDF| evaluation) runs hermetically.  Frames
are rendered on the sequence's device with a 96-step sphere trace.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.se3 import Isometry
from .base import FrameData, FrameIntrinsic, RGBDSequence

_SPHERE_C = (0.3, 0.6, 0.2)
_BOX_C = (1.3, 0.4, -1.0)
_BOX_HALF = (0.4, 0.4, 0.35)


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Analytic room SDF. p: (..., 3) world points (y up)."""
    floor = p[..., 1]
    wall_z = p[..., 2] + 2.2
    wall_x = p[..., 0] + 2.2
    c = p.new_tensor(_SPHERE_C)
    sph = torch.linalg.vector_norm(p - c, dim=-1) - 0.6
    q = torch.abs(p - p.new_tensor(_BOX_C)) - p.new_tensor(_BOX_HALF)
    box = torch.linalg.vector_norm(torch.clamp_min(q, 0.0), dim=-1) \
        + torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    return torch.minimum(torch.minimum(torch.minimum(floor, wall_z),
                                       torch.minimum(wall_x, sph)), box)


def _albedo(p: torch.Tensor) -> torch.Tensor:
    """Procedural texture giving the photometric term real gradients."""
    checker = torch.remainder(torch.floor(p[..., 0] * 3) + torch.floor(p[..., 2] * 3), 2)
    stripes = 0.5 + 0.5 * torch.sin(7.0 * p[..., 0]) * torch.sin(5.0 * p[..., 1])
    base = 0.35 + 0.4 * checker[..., None] * p.new_tensor([0.9, 0.6, 0.3]) \
        + 0.25 * stripes[..., None] * p.new_tensor([0.2, 0.5, 0.9])
    return torch.clamp(base, 0.05, 1.0)


def _render(R, t, fx, fy, cx, cy, H: int, W: int):
    """Sphere-trace one frame. R, t: camera-to-world. Returns (rgb, depth)."""
    dev = R.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    inv_norm = 1.0 / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    d_cam_n = d_cam * inv_norm
    d_world = d_cam_n @ R.T
    origin = t[None, None, :]
    t_ray = torch.full((H, W), 0.05, dtype=torch.float32, device=dev)
    for _ in range(96):
        s = scene_sdf(origin + t_ray[..., None] * d_world)
        t_ray = t_ray + torch.clamp(s, 0.0, 0.4)
    p_hit = origin + t_ray[..., None] * d_world
    s_final = scene_sdf(p_hit)
    hit = (torch.abs(s_final) < 5e-3) & (t_ray < 12.0)
    # z-depth (pinhole depth image), not ray length
    zdepth = t_ray * d_cam_n[..., 2]
    depth = torch.where(hit, zdepth, torch.full_like(zdepth, float("nan")))
    eps = 1e-3
    grad = torch.stack([
        scene_sdf(p_hit + p_hit.new_tensor([eps, 0, 0]))
        - scene_sdf(p_hit - p_hit.new_tensor([eps, 0, 0])),
        scene_sdf(p_hit + p_hit.new_tensor([0, eps, 0]))
        - scene_sdf(p_hit - p_hit.new_tensor([0, eps, 0])),
        scene_sdf(p_hit + p_hit.new_tensor([0, 0, eps]))
        - scene_sdf(p_hit - p_hit.new_tensor([0, 0, eps])),
    ], -1)
    n = grad / torch.clamp_min(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), 1e-9)
    light = p_hit.new_tensor([0.4, 0.8, 0.45])
    light = light / torch.linalg.vector_norm(light)
    shade = 0.35 + 0.65 * torch.clamp_min(n @ light, 0.0)
    rgb = _albedo(p_hit) * shade[..., None]
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    return rgb, depth


class SyntheticSequence(RGBDSequence):
    """Sphere-traced RGB-D frames along a smooth orbit trajectory."""

    def __init__(self, n_frames: int = 200, width: int = 640, height: int = 480,
                 radius: float = 1.6, angular_span: float = 1.2,
                 load_gt: bool = True, start_frame: int = 0,
                 end_frame: int = -1, scene: str = "room", device="cpu"):
        super().__init__()
        if scene != "room":
            raise NotImplementedError(f"synthetic scene {scene!r} is not ported yet")
        if end_frame == -1:
            end_frame = n_frames
        self.W, self.H = width, height
        self.device = torch.device(device)
        f = 481.2 * width / 640.0
        self.calib = FrameIntrinsic(f, f, width / 2.0 - 0.5, height / 2.0 - 0.5, 5000.0)
        center = np.array([0.4, 0.5, -0.3])
        poses = []
        for i in range(n_frames):
            a = -0.5 + angular_span * i / max(n_frames - 1, 1)
            cam = center + np.array([radius * np.sin(a) + 0.7,
                                     0.75 + 0.12 * np.sin(2.2 * a),
                                     radius * np.cos(a) + 0.7])
            poses.append(Isometry.look_at(cam, center, up=np.array([0.0, -1.0, 0.0])))
        self.gt_trajectory = poses[start_frame:end_frame] if load_gt else None
        self._poses = poses[start_frame:end_frame]
        self.first_iso = self._poses[0]
        # the analytic scene SDF: an exact mesh-quality oracle
        self.scene_sdf = scene_sdf

    def __len__(self):
        return len(self._poses)

    def render_frame(self, idx: int) -> FrameData:
        iso = self._poses[idx]
        R = torch.as_tensor(iso.q.rotation_matrix, dtype=torch.float32, device=self.device)
        t = torch.as_tensor(iso.t, dtype=torch.float32, device=self.device)
        c = self.calib
        rgb, depth = _render(R, t, c.fx, c.fy, c.cx, c.cy, self.H, self.W)
        frame = FrameData()
        frame.rgb = rgb
        frame.depth = depth
        frame.gt_pose = iso if self.gt_trajectory is not None else None
        frame.calib = self.calib
        return frame

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        frame = self.render_frame(self.frame_id)
        self.frame_id += 1
        return frame
