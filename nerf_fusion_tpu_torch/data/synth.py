"""Synthetic RGB-D sequence: a sphere-traced analytic SDF scene.

Counterpart of the JAX package's ``data/synth.py``: a procedurally
textured scene rendered along a known trajectory, so the whole loop
(tracking, fusion, meshing, ATE and mesh |SDF| evaluation) runs
hermetically.  Two scenes: "room" (floor, two walls, a sphere, a box; a
smooth orbit) and "large" (an 8x8 m two-room apartment; a figure-eight
walk through the doorway).  Frames are rendered on the sequence's device
with a 96-step sphere trace; on the card, iterating the sequence renders
``RENDER_BATCH`` frames in each call.
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


def _box_sdf(p: torch.Tensor, center, half) -> torch.Tensor:
    q = torch.abs(p - p.new_tensor(center)) - p.new_tensor(half)
    return torch.linalg.vector_norm(torch.clamp_min(q, 0.0), dim=-1) \
        + torch.clamp_max(torch.amax(q, dim=-1), 0.0)


def scene_sdf_large(p: torch.Tensor) -> torch.Tensor:
    """ScanNet-scale analytic scene: an 8x8 m two-room apartment (y up).

    Outer walls on all four sides, a dividing wall at z = 0 with a 1.6 m
    doorway, and furniture-scale objects in both rooms."""
    floor = p[..., 1]
    walls = torch.minimum(
        torch.minimum(p[..., 0] + 4.0, 4.0 - p[..., 0]),
        torch.minimum(p[..., 2] + 4.0, 4.0 - p[..., 2]))
    div_a = _box_sdf(p, [-2.4, 1.3, 0.0], [1.6, 1.3, 0.08])
    div_b = _box_sdf(p, [2.4, 1.3, 0.0], [1.6, 1.3, 0.08])
    # room A (z < 0)
    sph_a = torch.linalg.vector_norm(p - p.new_tensor([-2.0, 0.6, -2.0]), dim=-1) - 0.6
    box_a = _box_sdf(p, [2.0, 0.4, -2.4], [0.45, 0.4, 0.35])
    tab_a = _box_sdf(p, [0.2, 0.35, -3.2], [0.8, 0.35, 0.4])
    # room B (z > 0)
    sph_b = torch.linalg.vector_norm(p - p.new_tensor([2.2, 0.5, 2.4]), dim=-1) - 0.5
    box_b = _box_sdf(p, [-2.2, 0.5, 2.2], [0.5, 0.5, 0.5])
    dxz = torch.stack([
        torch.linalg.vector_norm(p[..., ::2] - p.new_tensor([0.4, 3.1]), dim=-1) - 0.45,
        torch.abs(p[..., 1] - 0.55) - 0.55], -1)
    cyl_b = torch.clamp_max(torch.amax(dxz, dim=-1), 0.0) \
        + torch.linalg.vector_norm(torch.clamp_min(dxz, 0.0), dim=-1)
    out = floor
    for s in (walls, div_a, div_b, sph_a, box_a, tab_a, sph_b, box_b, cyl_b):
        out = torch.minimum(out, s)
    return out


SCENES = {"room": scene_sdf, "large": scene_sdf_large}


def _albedo(p: torch.Tensor) -> torch.Tensor:
    """Procedural texture giving the photometric term real gradients."""
    checker = torch.remainder(torch.floor(p[..., 0] * 3) + torch.floor(p[..., 2] * 3), 2)
    stripes = 0.5 + 0.5 * torch.sin(7.0 * p[..., 0]) * torch.sin(5.0 * p[..., 1])
    base = 0.35 + 0.4 * checker[..., None] * p.new_tensor([0.9, 0.6, 0.3]) \
        + 0.25 * stripes[..., None] * p.new_tensor([0.2, 0.5, 0.9])
    return torch.clamp(base, 0.05, 1.0)


RENDER_BATCH = 8      # frames a render call when the sequence is iterated on the card


def _render(R, t, fx, fy, cx, cy, H: int, W: int, scene_sdf=scene_sdf):
    """Sphere-trace the scene whose SDF is ``scene_sdf``.  R, t:
    camera-to-world, (3, 3) and (3,) for one frame, or (B, 3, 3) and (B, 3)
    for B frames in one pass (each kernel over all B, the products frame by
    frame, so each frame is bitwise its own render).  Returns (rgb, depth),
    with a leading B for a batch."""
    dev = R.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    inv_norm = 1.0 / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    d_cam_n = d_cam * inv_norm
    if R.dim() == 2:
        d_world = d_cam_n @ R.T
        origin = t[None, None, :]
    else:
        d_world = torch.stack([d_cam_n @ r.T for r in R])
        origin = t[:, None, None, :]
    t_ray = torch.full(d_world.shape[:-1], 0.05, dtype=torch.float32, device=dev)
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
    lit = n @ light if R.dim() == 2 else torch.stack([f @ light for f in n])
    shade = 0.35 + 0.65 * torch.clamp_min(lit, 0.0)
    rgb = _albedo(p_hit) * shade[..., None]
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    return rgb, depth


class SyntheticSequence(RGBDSequence):
    """Sphere-traced RGB-D frames along a known trajectory: an orbit of the
    room, or a figure-eight through the large scene.  ``seed`` is accepted
    for the JAX package's signature; both scenes are deterministic."""

    def __init__(self, n_frames: int = 200, width: int = 640, height: int = 480,
                 radius: float = 1.6, angular_span: float = 1.2,
                 seed: int = 0, load_gt: bool = True, start_frame: int = 0,
                 end_frame: int = -1, scene: str = "room", device="cpu"):
        super().__init__()
        if scene not in SCENES:
            raise ValueError(f"unknown synthetic scene {scene!r}; one of {sorted(SCENES)}")
        if end_frame == -1:
            end_frame = n_frames
        self.W, self.H = width, height
        self.scene = scene
        self.device = torch.device(device)
        f = 481.2 * width / 640.0
        self.calib = FrameIntrinsic(f, f, width / 2.0 - 0.5, height / 2.0 - 0.5, 5000.0)
        poses = []
        if scene == "large":
            # a figure-eight (Gerono lemniscate) whose crossing sits in the
            # z = 0 doorway, one lobe per room; the camera looks ahead along
            # the path with a slight downward pitch
            def pos(a):
                return np.array([0.9 * np.sin(2 * a), 1.25 + 0.06 * np.sin(3.1 * a),
                                 2.45 * np.sin(a)])

            for i in range(n_frames):
                th = 2.0 * np.pi * i / max(n_frames - 1, 1)
                target = pos(th + 0.55)
                target[1] -= 0.45
                poses.append(Isometry.look_at(pos(th), target, up=np.array([0.0, -1.0, 0.0])))
        else:
            center = np.array([0.4, 0.5, -0.3])
            for i in range(n_frames):
                a = -0.5 + angular_span * i / max(n_frames - 1, 1)
                cam = center + np.array([radius * np.sin(a) + 0.7,
                                         0.75 + 0.12 * np.sin(2.2 * a),
                                         radius * np.cos(a) + 0.7])
                poses.append(Isometry.look_at(cam, center, up=np.array([0.0, -1.0, 0.0])))
        self.gt_trajectory = poses[start_frame:end_frame] if load_gt else None
        self._poses = poses[start_frame:end_frame]
        self.first_iso = self._poses[0]
        # the analytic SDF of the rendered scene: an exact mesh-quality oracle
        self.scene_sdf = SCENES[scene]
        self._ahead = {}

    def __len__(self):
        return len(self._poses)

    def render_frame(self, idx: int) -> FrameData:
        iso = self._poses[idx]
        R = torch.as_tensor(iso.q.rotation_matrix, dtype=torch.float32, device=self.device)
        t = torch.as_tensor(iso.t, dtype=torch.float32, device=self.device)
        c = self.calib
        rgb, depth = _render(R, t, c.fx, c.fy, c.cx, c.cy, self.H, self.W, self.scene_sdf)
        frame = FrameData()
        frame.rgb = rgb
        frame.depth = depth
        frame.gt_pose = iso if self.gt_trajectory is not None else None
        frame.calib = self.calib
        return frame

    def _render_ahead(self, idx: int) -> FrameData:
        """Frame ``idx`` from a batch render of ``RENDER_BATCH`` frames from
        it on (the card: the sphere trace launches a few thousand small
        kernels a frame, about 8000 in the large scene, and a batch launches
        them once for all its frames); bitwise ``render_frame(idx)``."""
        if idx not in self._ahead:
            ids = range(idx, min(idx + RENDER_BATCH, len(self)))
            R = torch.as_tensor(np.stack([self._poses[i].q.rotation_matrix for i in ids]),
                                dtype=torch.float32, device=self.device)
            t = torch.as_tensor(np.stack([self._poses[i].t for i in ids]),
                                dtype=torch.float32, device=self.device)
            c = self.calib
            rgb, depth = _render(R, t, c.fx, c.fy, c.cx, c.cy, self.H, self.W,
                                 self.scene_sdf)
            self._ahead = {i: (rgb[k], depth[k]) for k, i in enumerate(ids)}
        rgb, depth = self._ahead.pop(idx)
        frame = FrameData()
        frame.rgb = rgb
        frame.depth = depth
        frame.gt_pose = self._poses[idx] if self.gt_trajectory is not None else None
        frame.calib = self.calib
        return frame

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        if self.device.type == "cuda":
            frame = self._render_ahead(self.frame_id)
        else:
            frame = self.render_frame(self.frame_id)
        self.frame_id += 1
        return frame
