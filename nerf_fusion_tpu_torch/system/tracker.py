"""SDF + photometric camera tracker: Gauss-Newton on the device.

Counterpart of the JAX package's ``system/tracker.py``.  The staged
``iter_config`` schedule, robust kernels, per-group energy-increase
rejection with revert, the non-finite guards and the divergence state
machine are the same; the normal equations are built and solved on the
device.  The JAX version's early exit is a device ``while_loop``; here
each iteration reads its energy to the host (one small transfer per
iteration) and the loop stops there, with the same accept/revert rule and
the same ``iters_used``.

SDF residuals are ``r = sdf(T p) / std`` with std held constant; the
position gradient comes from the decoder kernel's forward-mode input
gradient through ``torch.autograd.grad``, chain-ruled to the twist of the
last pose: J = [dS/dx R_last, (delta p) x (dS/dx R_last)].  The
photometric term of a level is one ``ops.photometric.photometric_hg``
call: one kernel launch on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import se3_torch as st
from ..utils.config import dict_to_args
from ..utils.se3 import Isometry
from ..ops import imgproc, photometric
from .frontend import preprocess_frame
from .map import get_sdf


class TrackerConfig(NamedTuple):
    """Snapshot of the tracking yaml."""
    iter_config: tuple          # ((n, (('sdf',), ('rgb', 0))), ...)
    sdf_robust_kernel: str
    sdf_robust_k: float
    subsample: float
    rgb_robust_kernel: str
    rgb_robust_k: float
    min_grad_scale: float
    max_depth_delta: float
    motion_weight: float
    rgb_stride: int
    scale_level_intrinsics: bool
    # sparse photometric term: top-k gradient pixels per used pyramid level
    # (0 = dense); selected once per frame, gathered at k rows per GN step
    rgb_pixel_budget: int = 0
    outlier_radius: float = 0.05
    outlier_min_nb: int = 16
    normal_radius: float = 0.1
    normal_min_nb: int = 5
    box_filter_size: float = 0.02

    @staticmethod
    def from_args(args) -> "TrackerConfig":
        def as_dict(v):
            return v if isinstance(v, dict) else vars(v)

        sdf, rgb = as_dict(args.sdf), as_dict(args.rgb)
        pre = as_dict(getattr(args, "preprocess", {}) or {})
        motion = as_dict(getattr(args, "motion", {}) or {})
        if not bool(pre.get("box_filter_exact", True)):
            raise NotImplementedError(
                "preprocess.box_filter_exact: false (hash box filter) is not ported yet")
        groups = []
        for g in args.iter_config:
            groups.append((int(g["n"]), tuple(tuple(t) for t in g["type"])))
        return TrackerConfig(
            iter_config=tuple(groups),
            sdf_robust_kernel=sdf.get("robust_kernel"),
            sdf_robust_k=float(sdf.get("robust_k", 1.0)),
            subsample=float(sdf.get("subsample", 0.5)),
            rgb_robust_kernel=rgb.get("robust_kernel"),
            rgb_robust_k=float(rgb.get("robust_k", 0.01)),
            min_grad_scale=float(rgb.get("min_grad_scale", 0.0)),
            max_depth_delta=float(rgb.get("max_depth_delta", 0.2)),
            rgb_stride=int(rgb.get("stride", 1)),
            scale_level_intrinsics=bool(rgb.get("scale_intrinsics", False)),
            rgb_pixel_budget=int(rgb.get("pixel_budget", 0)),
            motion_weight=float(motion.get("weight", 1.0)),
            outlier_radius=float(pre.get("outlier_radius", 0.05)),
            outlier_min_nb=int(pre.get("outlier_min_nb", 16)),
            normal_radius=float(pre.get("normal_radius", 0.1)),
            normal_min_nb=int(pre.get("normal_min_nb", 5)),
            box_filter_size=float(pre.get("box_filter_size", 0.02)),
        )


def _sdf_Hg(map_state, map_cfg, decoder, tcfg: TrackerConfig,
            last_R, last_t, dR, dt, pts, mask):
    """SDF term: H (6, 6), g (6,), energy ()."""
    p_delta = st.transform_points(dR, dt, pts)              # delta @ p
    p_world = st.transform_points(last_R, last_t, p_delta).detach().requires_grad_(True)
    with torch.enable_grad():
        sdf, std, valid = get_sdf(map_state, map_cfg, decoder, p_world)
        r_g = sdf / std.detach()
        (dsdf_dpos,) = torch.autograd.grad(r_g, p_world, torch.ones_like(r_g))
    r = r_g.detach()
    m = (mask & valid).to(r.dtype)
    # The twist lives in the last-camera frame (delta <- exp(xi) o delta),
    # so the world gradient chain-rules through d x_world / d rho = R_last.
    La = last_R.T @ dsdf_dpos.T                               # (3, M)
    q = p_delta.T                                             # (3, M)
    Lb = torch.stack([q[1] * La[2] - q[2] * La[1],
                      q[2] * La[0] - q[0] * La[2],
                      q[0] * La[1] - q[1] * La[0]], 0)
    J = torch.cat([La, Lb], dim=0)                            # (6, M)
    w = photometric.robust_weight(r, tcfg.sdf_robust_kernel, tcfg.sdf_robust_k) * m
    scale = 1.0 / torch.clamp_min(m.sum(), 1.0)
    H = ((J * w[None, :]) @ J.T) * scale
    g = (J @ (w * r)) * scale
    energy = torch.sum(r * (w * r)) * scale
    return H, g, energy


def _intrinsics(fx, fy, cx, cy, device):
    f = [torch.tensor(v, dtype=torch.float32, device=device) for v in (fx, fy, cx, cy)]
    fx, fy, cx, cy = f
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, one])])
    Kinv = torch.stack([torch.stack([1.0 / fx, zero, -cx / fx]),
                        torch.stack([zero, 1.0 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])])
    return K, Kinv


def _rgb_Hg(tcfg: TrackerConfig, level_data, fx, fy, cx, cy, dR, dt, rgb_weight,
            sparse=None, K=None):
    """Photometric term at one pyramid level: one ``photometric_hg`` call.

    ``level_data``: (prev_rows (H*W, 2), cur intensity, cur depth, cur
    gradient) for the dense warp.  ``sparse``: optional (prev_rows, W, H,
    pix) from the once-per-frame pixel selection; replaces the dense warp.
    ``K``: the level's (K, K^-1) from ``_intrinsics``, built here if None."""
    Km, Kinv = _intrinsics(fx, fy, cx, cy, dR.device) if K is None else K
    krkinv = Km @ dR @ Kinv
    kt = Km @ dt
    if sparse is not None:
        prev_rows, W, H_, pix = sparse
        level = photometric.Sparse(W, H_, pix)
    else:
        prev_rows, cur_i, cur_d, cur_g = level_data
        level = photometric.Dense(cur_i, cur_d, cur_g)
    H, g, energy, _ = photometric.photometric_hg(
        prev_rows, level, krkinv, kt, fx, fy, cx, cy,
        min_grad_scale=tcfg.min_grad_scale, max_depth_delta=tcfg.max_depth_delta,
        stride=tcfg.rgb_stride, robust_kernel=tcfg.rgb_robust_kernel,
        robust_k=tcfg.rgb_robust_k, rgb_weight=rgb_weight)
    return H, g, energy


def _motion_Hg(tcfg: TrackerConfig, dR, dt):
    """Constant-velocity prior: penalise the delta twist."""
    xi = torch.cat([dt, st.so3_log(dR)])
    w = tcfg.motion_weight
    return (w * torch.eye(6, dtype=dt.dtype, device=dt.device), w * xi,
            w * torch.sum(xi * xi))


def track_gauss_newton(map_state, map_cfg, decoder, tcfg: TrackerConfig,
                       prev_pyr, cur_pyr, pts, mask, last_R, last_t,
                       init_dR, init_dt, fx, fy, cx, cy, rgb_weight):
    """The staged GN schedule; returns (dR, dt, iters_used [G] host ints)."""

    # The packed previous frame, the level's intrinsics (K, K^-1) and for
    # the sparse photometric term the pixel selection, once per frame for
    # each pyramid level a group uses.
    used = {int(t[1]) if len(t) > 1 else 0
            for _, terms in tcfg.iter_config for t in terms if t[0] == "rgb"}
    prev_rows = {lev: imgproc.intensity_depth_rows(prev_pyr.intensity[lev],
                                                   prev_pyr.depth[lev])
                 for lev in sorted(used)}
    scales = {lev: 0.5 ** lev if tcfg.scale_level_intrinsics else 1.0 for lev in used}
    intr = {lev: _intrinsics(fx * s, fy * s, cx * s, cy * s, init_dR.device)
            for lev, s in sorted(scales.items())}
    sparse_levels = {}
    if tcfg.rgb_pixel_budget > 0:
        for lev in sorted(used):
            pix = imgproc.select_photometric_pixels(
                cur_pyr.intensity[lev], cur_pyr.depth[lev], cur_pyr.gradient[lev],
                tcfg.rgb_pixel_budget, tcfg.min_grad_scale, stride=tcfg.rgb_stride)
            Hl, Wl = cur_pyr.intensity[lev].shape
            sparse_levels[lev] = (prev_rows[lev], Wl, Hl, pix)

    def build_Hg(terms, dR, dt):
        H = torch.zeros((6, 6), dtype=torch.float32, device=dR.device)
        g = torch.zeros(6, dtype=torch.float32, device=dR.device)
        energy = torch.zeros((), dtype=torch.float32, device=dR.device)
        for term in terms:
            if term[0] == "sdf":
                Ht, gt, et = _sdf_Hg(map_state, map_cfg, decoder, tcfg,
                                     last_R, last_t, dR, dt, pts, mask)
            elif term[0] == "rgb":
                lev = int(term[1]) if len(term) > 1 else 0
                s = scales[lev]
                level_data = (prev_rows[lev], cur_pyr.intensity[lev],
                              cur_pyr.depth[lev], cur_pyr.gradient[lev])
                Ht, gt, et = _rgb_Hg(tcfg, level_data, fx * s, fy * s,
                                     cx * s, cy * s, dR, dt, rgb_weight,
                                     sparse=sparse_levels.get(lev), K=intr[lev])
            elif term[0] == "motion":
                Ht, gt, et = _motion_Hg(tcfg, dR, dt)
            else:
                raise ValueError(f"unknown tracking term {term[0]!r}")
            H, g, energy = H + Ht, g + gt, energy + et
        return H, g, energy

    eye6 = 1e-9 * torch.eye(6, dtype=torch.float32, device=init_dR.device)
    dR, dt = init_dR, init_dt
    iters_used = []
    for n_iters, terms in tcfg.iter_config:
        # Early exit as in the JAX while_loop: evaluate, reject a worse (or
        # non-finite) energy by reverting to the best pose and stopping.
        bR, bt = dR, dt
        last_energy = float("inf")
        used = 0
        i = 0
        while i <= n_iters:
            H, g, energy = build_Hg(terms, dR, dt)
            e = float(energy)
            worse = not (e <= last_energy) or not np.isfinite(e)
            if worse:
                dR, dt = bR, bt
                break
            bR, bt, last_energy, used = dR, dt, e, i
            if i < n_iters:
                xi, _ = torch.linalg.solve_ex(H + eye6, -g)
                # a singular H gives a non-finite step: keep the pose
                xi = torch.where(torch.isfinite(xi).all(), xi, torch.zeros_like(xi))
                eR, et = st.se3_exp(xi)
                dR, dt = st.compose(eR, et, dR, dt)
            i += 1
        iters_used.append(used)
    return dR, dt, iters_used


def track_and_update(map_state, map_cfg, decoder, tcfg: TrackerConfig,
                     prev_pyr, cur_pyr, pts, mask, last_R, last_t,
                     fx, fy, cx, cy, rgb_weight: float, n_unstable: int):
    """GN + pose composition + the divergence state machine (3 unstable
    frames raise the rgb weight to >= 500).
    :return: (pose_R, pose_t, rgb_weight', n_unstable', iters)."""
    eye = torch.eye(3, dtype=torch.float32, device=last_R.device)
    zero = torch.zeros(3, dtype=torch.float32, device=last_R.device)
    dR, dt, iters = track_gauss_newton(
        map_state, map_cfg, decoder, tcfg, prev_pyr, cur_pyr, pts, mask,
        last_R, last_t, eye, zero, fx, fy, cx, cy, rgb_weight)
    pose_R, pose_t = st.compose(last_R, last_t, dR, dt)
    n_unstable = n_unstable + int(iters[-1] >= 10)
    if n_unstable >= 3:
        rgb_weight = max(rgb_weight, 500.0)
    return pose_R, pose_t, rgb_weight, n_unstable, iters


class SDFTracker:
    """Tracker front: preprocessing, GN and the device pose log."""

    def __init__(self, vmap, args, point_budget: int = 16384,
                 gn_point_budget: int = None):
        self.map = vmap
        self.device = vmap.device
        if isinstance(args, dict):
            args = dict_to_args(args)
        self.tcfg = TrackerConfig.from_args(args)
        rgb = args.rgb if isinstance(args.rgb, dict) else vars(args.rgb)
        self.rgb_weight = float(rgb["weight"])
        self.n_unstable = 0
        self.point_budget = point_budget
        # GN uses a prefix of the hash-ordered box-filtered cloud.
        self.gn_point_budget = min(gn_point_budget or 8192, point_budget)
        self.all_pd_pose = []          # device (R, t) per tracked frame
        self.n_tracked = 0
        # Preallocated device pose log appended in place; when full it
        # spills to a host archive and restarts at row 0.
        self.pose_log_capacity = 16384
        self._pose_log = torch.zeros((self.pose_log_capacity, 3, 4),
                                     dtype=torch.float32, device=self.device)
        self._pose_count = 0
        self._pose_archive = []
        self._n_archived = 0
        self.prev_pyr = None
        self.last_processed_pc = None  # device (points, normals, mask)
        self.drop_fracs = []           # device scalars, fetched in one batch

    def preprocess(self, rgb, depth, calib, depth_cut=(0.5, 5.0)):
        t = self.tcfg
        return preprocess_frame(
            torch.as_tensor(rgb, device=self.device),
            torch.as_tensor(depth, device=self.device),
            calib.fx, calib.fy, calib.cx, calib.cy,
            depth_cut[0], depth_cut[1], self.point_budget,
            subsample=t.subsample,
            depth_scale=float(getattr(calib, "dscale", 1.0)),
            outlier_radius=t.outlier_radius, outlier_min_nb=t.outlier_min_nb,
            normal_radius=t.normal_radius, normal_min_nb=t.normal_min_nb,
            box_filter_size=t.box_filter_size)

    def _spill_pose_log(self, needed: int):
        live = self.n_tracked - self._n_archived
        if live + needed <= self.pose_log_capacity:
            return
        self._pose_archive.append(self._pose_log[:live].to("cpu", copy=True).numpy())
        self._n_archived += live
        self._pose_count = 0

    def _append_pose(self, R, t):
        self._pose_log[self._pose_count, :, :3] = R
        self._pose_log[self._pose_count, :, 3] = t
        self._pose_count += 1

    def track_camera(self, rgb, depth, calib, set_pose: Isometry = None,
                     depth_cut=(0.5, 5.0)):
        """Returns the device pose (R (3, 3), t (3,))."""
        self._spill_pose_log(1)
        pre = self.preprocess(rgb, depth, calib, depth_cut)
        if set_pose is not None:
            pose = (torch.as_tensor(set_pose.q.rotation_matrix, dtype=torch.float32,
                                    device=self.device),
                    torch.as_tensor(set_pose.t, dtype=torch.float32, device=self.device))
        else:
            if not self.all_pd_pose:
                raise RuntimeError("first frame needs set_pose (first_iso)")
            last_R, last_t = self.all_pd_pose[-1]
            k = self.gn_point_budget
            pose_R, pose_t, self.rgb_weight, self.n_unstable, _ = \
                track_and_update(
                    self.map.state, self.map.cfg, self.map.model.decoder,
                    self.tcfg, self.prev_pyr, pre.pyramid,
                    pre.points[:k], pre.mask[:k], last_R, last_t,
                    calib.fx, calib.fy, calib.cx, calib.cy,
                    self.rgb_weight, self.n_unstable)
            pose = (pose_R, pose_t)
        self._append_pose(*pose)
        self.last_processed_pc = (pre.points, pre.normals, pre.mask)
        self.drop_fracs.append(pre.drop_frac)
        self.prev_pyr = pre.pyramid
        self.all_pd_pose.append(pose)
        self.n_tracked += 1
        return pose

    def pose_history(self):
        """The pose chain as host Isometries (one transfer)."""
        n = self.n_tracked
        if n == 0:
            return []
        live = n - self._n_archived
        log = self._pose_log[:live].cpu().numpy()
        if self._pose_archive:
            log = np.concatenate(self._pose_archive + [log])
        return [Isometry.from_matrix(np.asarray(e[:, :3], np.float64),
                                     np.asarray(e[:, 3], np.float64), ortho=True)
                for e in log]
