"""SDF + photometric camera tracker: Gauss-Newton with its state on the device.

Counterpart of the JAX package's ``system/tracker.py``.  The staged
``iter_config`` schedule, robust kernels, per-group energy-increase
rejection with revert, the non-finite guards and the divergence state
machine are the same, and so is where they run: on the device.

A tracked frame is three functions over tensors that keep their storage
from frame to frame (``_FrameStep``), the counterpart of JAX's
``fused_frame_step``:

  * prelude: ``preprocess_frame`` on the frame's input buffers, the reset
    of the GN state (``ops.gn.GNState``) and, for the sparse photometric
    term, the pixel selection of each used pyramid level;
  * iteration(g): the normal equations of group g's terms at the current
    delta pose and one ``ops.gn.gn_step`` (the body of JAX's per-group
    ``while_loop``);
  * epilogue: the pose composition, the divergence state machine (3
    unstable frames raise the rgb weight to >= 500), the pose-log append at
    a device counter and the packed rows of this frame's pyramid, which the
    next frame's photometric term warps into.

The host runs each group's loop: it runs iteration(g) and reads the
one-byte ``done`` flag, the condition that JAX's ``while_loop`` evaluates
on the device, so the evaluations, ``iters_used`` and poses are those of
the JAX loop.  On the card the three functions are captured as CUDA graphs
on the first tracked frame of a calibration (which runs eagerly on a side
stream first, as the warm-up) and replayed on every later frame; on the CPU
they run eagerly.  A capture or replay that fails raises.  A frame with
``set_pose`` runs eagerly, as JAX's does.

Spans (``utils/trace.py``): ``tracker.prelude``, one ``tracker.eval`` and
``tracker.done_read`` an evaluation and ``tracker.epilogue`` around the
replays or eager calls of a tracked frame; ``frontend.preprocess`` and
``tracker.finish`` on the ``set_pose`` path.  Counters:
``tracker.gn_evals.g<k>``, group k's evaluations; ``tracker.graph_nodes.g<k>``,
the kernel nodes of group k's evaluation graph, at each capture.

SDF residuals are ``r = sdf(T p) / std`` with std held constant; the
position gradient is the decoder kernel's forward-mode d sdf / d rel,
chained to world coordinates as (1 / std) grad / voxel_size and to the
twist of the last pose: J = [dS/dx R_last, (delta p) x (dS/dx R_last)].
The SDF term is three kernel launches on the card (``ops.sdf_term``
``sdf_rows``, ``ops.mlp.decoder_forward_grad``, ``sdf_term.sdf_hg``), the
photometric term of a level one (``ops.photometric.photometric_hg``, which
forms K dR K^-1 and K dt itself), and ``gn.gn_step`` sums the terms: a GN
evaluation is hand-written kernels only, each reading the delta pose where
the last step wrote it, so an SDF-plus-rgb group's graph holds five kernel
nodes and an rgb-only group's two (``_Graph.nodes``, counted at capture
into ``tracker.graph_nodes.g<k>``).

``track_points_lm`` is the SDF-only Levenberg-Marquardt point tracker (no
path of the loop calls it): a fixed number of iterations with the pose,
damping and energy on the device, so the host reads nothing in its loop.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import numpy as np
import torch

from ..utils import se3_torch as st
from ..utils import trace
from ..utils.config import dict_to_args
from ..utils.se3 import Isometry
from ..ops import cuda_build, gn, imgproc, launches, photometric, sdf_term
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
    box_filter_exact: bool = True  # False: the hash box filter

    @staticmethod
    def from_args(args) -> "TrackerConfig":
        def as_dict(v):
            return v if isinstance(v, dict) else vars(v)

        sdf, rgb = as_dict(args.sdf), as_dict(args.rgb)
        pre = as_dict(getattr(args, "preprocess", {}) or {})
        motion = as_dict(getattr(args, "motion", {}) or {})
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
            box_filter_exact=bool(pre.get("box_filter_exact", True)),
        )


def _sdf_Hg(map_state, map_cfg, decoder, tcfg: TrackerConfig,
            last_R, last_t, dR, dt, pts, mask, bound_min=None):
    """SDF term: H (6, 6), g (6,), energy (); ``sdf_term.sdf_rows``, the
    decoder's ``forward_grad`` and ``sdf_term.sdf_hg``."""
    if bound_min is None:
        bound_min = torch.as_tensor(map_cfg.bound_min, dtype=torch.float32, device=pts.device)
    x, p_delta, use = sdf_term.sdf_rows(
        pts, mask, dR, dt, last_R, last_t, bound_min, map_cfg.voxel_size, map_cfg.n_xyz,
        map_state.indexer, map_state.obs_count, map_state.latents, map_cfg.ignore_count_th)
    out, grad = decoder.forward_grad(x)
    res = sdf_term.sdf_hg(out, grad, p_delta, use, last_R, map_cfg.voxel_size,
                          tcfg.sdf_robust_kernel, tcfg.sdf_robust_k)
    return res[:36].view(6, 6), res[36:42], res[42]


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
    ``K``: the level's (K, K^-1) from ``_intrinsics``, built here if None.
    ``rgb_weight``: a float or a () tensor on the device."""
    K = _intrinsics(fx, fy, cx, cy, dR.device) if K is None else K
    if sparse is not None:
        prev_rows, W, H_, pix = sparse
        level = photometric.Sparse(W, H_, pix)
    else:
        prev_rows, cur_i, cur_d, cur_g = level_data
        level = photometric.Dense(cur_i, cur_d, cur_g)
    H, g, energy, _ = photometric.photometric_hg(
        prev_rows, level, dR, dt, fx, fy, cx, cy, K=K,
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


def used_levels(tcfg: TrackerConfig) -> tuple:
    """The pyramid levels the photometric terms of the schedule use."""
    return tuple(sorted({int(t[1]) if len(t) > 1 else 0
                         for _, terms in tcfg.iter_config for t in terms if t[0] == "rgb"}))


def _level_scale(tcfg: TrackerConfig, lev: int) -> float:
    return 0.5 ** lev if tcfg.scale_level_intrinsics else 1.0


def level_intrinsics(tcfg: TrackerConfig, fx, fy, cx, cy, device) -> dict:
    """(K, K^-1) of each used level, built once per calibration."""
    out = {}
    for lev in used_levels(tcfg):
        s = _level_scale(tcfg, lev)
        out[lev] = _intrinsics(fx * s, fy * s, cx * s, cy * s, device)
    return out


def track_points_lm(map_state, map_cfg, decoder, pts, mask, init_R, init_t,
                    n_iters: int = 20, damping_init: float = 1e-4, lm_eps4: float = 0.0,
                    lm_ldown: float = 9.0, lm_lup: float = 11.0, robust_k: float = 5.0,
                    bound_min=None):
    """Levenberg-Marquardt on the SDF term alone: the pose (R, t) that puts
    the points ``pts`` (N, 3) on the map's zero level set.

    Residual r = sdf(R p + t) / std (std held constant), Huber weights at
    ``robust_k``, masked by ``mask`` and the map's validity.  The pose is
    perturbed on the left in the world frame, pose <- exp(xi) o pose, so
    J = [dr/dx, x x dr/dx] with x the world points (not the GN tracker's
    last-camera frame); dr/dx = (d sdf / d rel) / (std voxel_size) from the
    decoder's forward-mode gradient (``decoder.forward_grad``, the
    ``decoder_forward_grad`` kernel on the card).  Each of the ``n_iters``
    iterations solves (H + damping diag(H) + 1e-12 I) xi = -g, decodes the
    candidate's energy forward only (``decoder``, the ``decoder_forward``
    kernel), accepts it if the gain ratio exceeds ``lm_eps4`` and divides
    or multiplies the damping by ``lm_ldown`` / ``lm_lup`` within [1e-7,
    1e7].  Everything stays on the device and nothing is read on the host.
    ``bound_min``: ``map_cfg.bound_min`` on the device (a copy from the host
    if None).  :return: (R, t, energy) device tensors.
    """
    dev = pts.device
    if bound_min is None:
        bound_min = torch.as_tensor(map_cfg.bound_min, dtype=torch.float32, device=dev)
    pts = pts.to(torch.float32)
    ridge = 1e-12 * torch.eye(6, dtype=torch.float32, device=dev)

    def residuals(R, t, with_jacobian: bool):
        pw = st.transform_points(R, t, pts)
        got = get_sdf(map_state, map_cfg, decoder, pw, bound_min, with_grad=with_jacobian)
        sdf, std, valid = got[:3]
        r = sdf / std
        m = (mask & valid).to(r.dtype)
        w = photometric.robust_weight(r, "huber", robust_k) * m
        energy = torch.sum(r * w * r) / torch.clamp_min(m.sum(), 1.0)
        if not with_jacobian:
            return energy
        Jr = ((torch.ones_like(std) / std)[:, None] * got[3] / map_cfg.voxel_size).T
        x = pw.T
        Jp = torch.stack([x[1] * Jr[2] - x[2] * Jr[1],
                          x[2] * Jr[0] - x[0] * Jr[2],
                          x[0] * Jr[1] - x[1] * Jr[0]], 0)
        return r, w, torch.cat([Jr, Jp], dim=0), energy           # J (6, M)

    R = init_R.to(torch.float32)
    t = init_t.to(torch.float32)
    damping = torch.full((), damping_init, dtype=torch.float32, device=dev)
    energy = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        r, w, J, energy = residuals(R, t, True)
        H = (J * w[None, :]) @ J.T
        g = J @ (w * r)
        DtD = damping * torch.diag(torch.diagonal(H))
        xi = torch.linalg.solve_ex(H + DtD + ridge, -g[:, None])[0][:, 0]
        eR, et = st.se3_exp(xi)
        nR, nt = st.compose(eR, et, R, t)
        new_energy = residuals(nR, nt, False)
        rho_den = torch.clamp_min(torch.sum(xi * (DtD @ xi)) + torch.sum(xi * -g), 1e-12)
        accept = (energy - new_energy) / rho_den > lm_eps4
        R = torch.where(accept, nR, R)
        t = torch.where(accept, nt, t)
        damping = torch.clamp(torch.where(accept, damping / lm_ldown, damping * lm_lup),
                              1e-7, 1e7)
        energy = torch.where(accept, new_energy, energy)
    return R, t, energy


class _Terms(NamedTuple):
    """What the normal equations of one frame read besides the delta pose."""
    map_state: tuple
    map_cfg: tuple
    decoder: object
    bound_min: torch.Tensor
    tcfg: TrackerConfig
    last_R: torch.Tensor
    last_t: torch.Tensor
    pts: torch.Tensor
    mask: torch.Tensor
    cur_pyr: tuple
    prev_rows: dict         # level -> (H*W, 2) rows of the previous frame
    sparse: dict            # level -> (prev_rows, W, H, pix): the sparse term
    intr: dict              # level -> (K, K^-1)
    fx: float
    fy: float
    cx: float
    cy: float
    rgb_weight: object      # () tensor or float


def _select(tcfg: TrackerConfig, cur_pyr, prev_rows) -> dict:
    """The sparse photometric term's pixel selection, once per frame for
    each used level (empty for the dense term)."""
    sparse = {}
    if tcfg.rgb_pixel_budget > 0:
        for lev in used_levels(tcfg):
            pix = imgproc.select_photometric_pixels(
                cur_pyr.intensity[lev], cur_pyr.depth[lev], cur_pyr.gradient[lev],
                tcfg.rgb_pixel_budget, tcfg.min_grad_scale, stride=tcfg.rgb_stride)
            Hl, Wl = cur_pyr.intensity[lev].shape
            sparse[lev] = (prev_rows[lev], Wl, Hl, pix)
    return sparse


def term_Hg(f: _Terms, terms, dR, dt):
    """The normal equations of each of ``terms`` at the delta pose, in
    order: ((H, ...), (g, ...), (energy, ...))."""
    parts = []
    for term in terms:
        if term[0] == "sdf":
            parts.append(_sdf_Hg(f.map_state, f.map_cfg, f.decoder, f.tcfg, f.last_R,
                                 f.last_t, dR, dt, f.pts, f.mask, f.bound_min))
        elif term[0] == "rgb":
            lev = int(term[1]) if len(term) > 1 else 0
            s = _level_scale(f.tcfg, lev)
            level_data = (f.prev_rows[lev], f.cur_pyr.intensity[lev], f.cur_pyr.depth[lev],
                          f.cur_pyr.gradient[lev])
            parts.append(_rgb_Hg(f.tcfg, level_data, f.fx * s, f.fy * s, f.cx * s,
                                 f.cy * s, dR, dt, f.rgb_weight, sparse=f.sparse.get(lev),
                                 K=f.intr[lev]))
        elif term[0] == "motion":
            parts.append(_motion_Hg(f.tcfg, dR, dt))
        else:
            raise ValueError(f"unknown tracking term {term[0]!r}")
    return tuple(zip(*parts))


def build_Hg(f: _Terms, terms, dR, dt):
    """The normal equations (H, g, energy) of ``terms`` at the delta pose,
    summed in PyTorch (``gn.sum_terms``)."""
    return gn.sum_terms(*term_Hg(f, terms, dR, dt))


def gn_iteration(f: _Terms, state: gn.GNState, group: int, step=gn.gn_step):
    """One evaluation of group ``group``'s terms and its GN step (in place),
    ``step`` with ``gn.gn_step``'s signature: ``gn.gn_step`` itself sums the
    terms (on the card inside its kernel), any other is handed the sums.
    :return: the evaluation's (H, g, energy)."""
    n_iters, terms = f.tcfg.iter_config[group]
    parts = term_Hg(f, terms, state.dR, state.dt)
    if step is gn.gn_step:
        return gn.gn_step(*parts, state, group, n_iters)
    H, g, energy = gn.sum_terms(*parts)
    step(H, g, energy, state, group, n_iters)
    return H, g, energy


def run_groups(tcfg: TrackerConfig, state: gn.GNState, iteration):
    """The host's side of the per-group loops (JAX's ``while_loop`` with
    ``cond = !done & i <= n_iters``): ``iteration(g)`` runs one evaluation
    and step of group g, then the host reads ``done`` unless the group's
    count ended it.  :return: (evaluations, host reads)."""
    evals = reads = 0
    for group, (n_iters, _) in enumerate(tcfg.iter_config):
        i = 0
        while True:
            with trace.span("tracker.eval"):
                iteration(group)
            evals += 1
            i += 1
            if i > n_iters:
                break
            reads += 1
            with trace.span("tracker.done_read"):
                done = bool(state.done)
            if done:
                break
        trace.count(_gn_evals_name(group), i)
    return evals, reads


_GN_EVALS = []


def _gn_evals_name(group: int) -> str:
    """The counter of group ``group``'s evaluations, made once."""
    while len(_GN_EVALS) <= group:
        _GN_EVALS.append(f"tracker.gn_evals.g{len(_GN_EVALS)}")
    return _GN_EVALS[group]


def divergence_update(iters, rgb_weight, n_unstable):
    """The divergence state machine on the device: a frame whose last group
    used >= 10 steps is unstable; from the third, the rgb weight is >= 500.
    :return: (rgb_weight', n_unstable')."""
    n_unstable = n_unstable + (iters[-1] >= 10).to(n_unstable.dtype)
    rgb_weight = torch.where(n_unstable >= 3, torch.clamp_min(rgb_weight, 500.0), rgb_weight)
    return rgb_weight, n_unstable


def track_gauss_newton(map_state, map_cfg, decoder, tcfg: TrackerConfig,
                       prev_pyr, cur_pyr, pts, mask, last_R, last_t,
                       init_dR, init_dt, fx, fy, cx, cy, rgb_weight, bound_min=None,
                       step=gn.gn_step):
    """The staged GN schedule on one frame pair, run eagerly; ``step`` is
    each evaluation's GN step (``gn.gn_step``'s signature).
    :return: (dR, dt, iters_used (G,) int32), all on the device."""
    dev = init_dR.device
    prev_rows = {lev: imgproc.intensity_depth_rows(prev_pyr.intensity[lev],
                                                   prev_pyr.depth[lev])
                 for lev in used_levels(tcfg)}
    f = _Terms(map_state, map_cfg, decoder, bound_min, tcfg, last_R, last_t, pts, mask,
               cur_pyr, prev_rows, _select(tcfg, cur_pyr, prev_rows),
               level_intrinsics(tcfg, fx, fy, cx, cy, dev), fx, fy, cx, cy, rgb_weight)
    state = gn.new_state(len(tcfg.iter_config), dev)
    start = torch.cat([init_dR.reshape(-1), init_dt]).to(torch.float32)
    state.pose[0:12] = start
    state.pose[12:24] = start
    run_groups(tcfg, state, lambda group: gn_iteration(f, state, group, step))
    return state.dR.clone(), state.dt.clone(), state.iters


class _Graph:
    """``fn()`` captured as a CUDA graph (``out``: its outputs, whose storage
    each replay rewrites; ``nodes``: its kernel nodes, read after the
    capture).  The capture launches nothing, so its launch counts are taken
    back; ``replay`` adds them once per replay.  The
    capture checks this thread's CUDA calls only: a reader's decode threads
    run beside it.  Python's cyclic garbage collector is off during the
    capture: a collection there destroys the CUDA graphs of an earlier
    tracker that only a reference cycle still held, and destroying a graph
    is not permitted while this thread captures (it invalidated a capture
    of the prelude on the card, once the smoke had run ten pipelines).  It
    holds ``launches.EXCLUSIVE``, so that no async mesher or refiner
    launches inside it."""

    def __init__(self, fn):
        # no worker thread launches while the counters are diffed
        with launches.EXCLUSIVE:
            before = launches.snapshot()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    self.out = fn()
            finally:
                if gc_on:
                    gc.enable()
            self.launches = launches.diff(launches.snapshot(), before)
            launches.add(self.launches, -1)
        self.nodes = cuda_build.graph_kernel_nodes(self.graph.raw_cuda_graph())
        self.graph.instantiate()

    def replay(self):
        self.graph.replay()
        launches.add(self.launches)


class _FrameStep:
    """One tracked frame of one calibration and frame format: the prelude,
    the iteration of each group and the epilogue (see the module's
    docstring), over the frame's input buffers ``rgb_in`` / ``depth_in``
    and the tracker's persistent state."""

    def __init__(self, tracker, rgb, depth, calib, depth_cut, key):
        self.tracker, self.calib, self.depth_cut, self.key = tracker, calib, depth_cut, key
        dev = tracker.device
        self.rgb_in = torch.empty(tuple(rgb.shape), dtype=rgb.dtype, device=dev)
        self.depth_in = torch.empty(tuple(depth.shape), dtype=depth.dtype, device=dev)
        self.intr = level_intrinsics(tracker.tcfg, calib.fx, calib.fy, calib.cx, calib.cy,
                                     dev)
        self.graphs = None

    def prelude(self):
        t, c = self.tracker, self.calib
        pre = t.preprocess(self.rgb_in, self.depth_in, c, self.depth_cut)
        gn.reset(t.gn, t.gn_initial)
        k = t.gn_point_budget
        self.pre = pre
        self.terms = _Terms(t.map.state, t.map.cfg, t.map.model.decoder, t.map.bound_min,
                            t.tcfg, t.last_R, t.last_t, pre.points[:k], pre.mask[:k],
                            pre.pyramid, t.prev_rows,
                            _select(t.tcfg, pre.pyramid, t.prev_rows), self.intr,
                            c.fx, c.fy, c.cx, c.cy, t.rgb_weight)
        return pre

    def iteration(self, group: int):
        return gn_iteration(self.terms, self.tracker.gn, group)

    def epilogue(self):
        return self.tracker._tracked_epilogue(self.pre)

    def _eager(self):
        with trace.span("tracker.prelude"):
            pre = self.prelude()
        evals, reads = run_groups(self.tracker.tcfg, self.tracker.gn, self.iteration)
        self.tracker.host_reads += reads
        with trace.span("tracker.epilogue"):
            return self.epilogue(), pre

    def run(self):
        """Track the frame in the input buffers: (out (13,) = [pose_R (9),
        pose_t (3), drop_frac], the frame's ``Preprocessed``); ``out`` is a
        tensor of its own."""
        t = self.tracker
        if t.device.type != "cuda":
            return self._eager()
        if self.graphs is None:
            # the warm-up on a side stream is this frame's work; the capture
            # after it runs nothing
            cur = torch.cuda.current_stream(t.device)
            side = torch.cuda.Stream(t.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out, pre = self._eager()
            cur.wait_stream(side)
            self.graphs = {
                "prelude": _Graph(self.prelude),
                "iteration": [_Graph(lambda g=g: self.iteration(g))
                              for g in range(len(t.tcfg.iter_config))],
                "epilogue": _Graph(self.epilogue)}
            for g, graph in enumerate(self.graphs["iteration"]):
                trace.count(f"tracker.graph_nodes.g{g}", graph.nodes)
            return out, pre
        graphs = self.graphs
        with trace.span("tracker.prelude"):
            graphs["prelude"].replay()
        evals, reads = run_groups(t.tcfg, t.gn, lambda g: graphs["iteration"][g].replay())
        with trace.span("tracker.epilogue"):
            graphs["epilogue"].replay()
            out = graphs["epilogue"].out.clone()
        t.graph_replays += evals + 2
        t.host_reads += reads
        return out, self.pre


class SDFTracker:
    """Tracker front: preprocessing, the frame step and the device pose log.

    The rgb weight, the unstable-frame count, the last pose, the previous
    frame's packed rows and the GN state are device tensors that keep their
    storage (the captured graphs read them).  ``graph_replays`` and
    ``host_reads`` count the CUDA graph replays and the host's reads of
    the done flag."""

    def __init__(self, vmap, args, point_budget: int = 16384,
                 gn_point_budget: int = None):
        self.map = vmap
        self.device = vmap.device
        if isinstance(args, dict):
            args = dict_to_args(args)
        self.tcfg = TrackerConfig.from_args(args)
        rgb = args.rgb if isinstance(args.rgb, dict) else vars(args.rgb)
        dev = self.device
        self.rgb_weight = torch.tensor(float(rgb["weight"]), dtype=torch.float32, device=dev)
        self.n_unstable = torch.zeros((), dtype=torch.int32, device=dev)
        self.point_budget = point_budget
        # GN uses a prefix of the hash-ordered box-filtered cloud.
        self.gn_point_budget = min(gn_point_budget or 8192, point_budget)
        self.gn = gn.new_state(len(self.tcfg.iter_config), dev)
        self.gn_initial = self.gn.pose.clone()
        self.last_R = torch.eye(3, dtype=torch.float32, device=dev)
        self.last_t = torch.zeros(3, dtype=torch.float32, device=dev)
        self.prev_rows = {}            # level -> (H*W, 2) rows of the last frame
        self._step = None
        self.graph_replays = 0
        self.host_reads = 0
        self.all_pd_pose = []          # device (R, t), one per track call
        self.n_tracked = 0
        # Preallocated device pose log appended in place at a device
        # counter; when full it spills to a host archive and restarts at 0.
        self.pose_log_capacity = 16384
        self._pose_log = torch.zeros((self.pose_log_capacity, 3, 4),
                                     dtype=torch.float32, device=dev)
        self._pose_count = torch.zeros(1, dtype=torch.int64, device=dev)
        self._pose_archive = []
        self._n_archived = 0
        # device (points, normals, mask) and (points, colors, mask) of the
        # last frame; on the card the captured prelude's outputs, which the
        # next tracked frame rewrites
        self.last_processed_pc = None
        self.last_colored_pcd = None
        # GN evaluations of each group of the last tracked frame (G,), or of
        # a block's frames (K, G); device int32
        self.last_iters = None
        self.drop_fracs = []           # device scalars or (K,) vectors

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
            box_filter_size=t.box_filter_size, box_filter_exact=t.box_filter_exact)

    def _spill_pose_log(self, needed: int):
        live = self.n_tracked - self._n_archived
        if live + needed <= self.pose_log_capacity:
            return
        self._pose_archive.append(self._pose_log[:live].to("cpu", copy=True).numpy())
        self._n_archived += live
        self._pose_count.zero_()

    def _finish(self, pre, pose_R, pose_t):
        """The end of every frame: the last pose, the pose-log append at the
        device counter, the packed rows for the next frame's photometric
        term.  :return: out (13,) = [pose_R, pose_t, drop_frac]."""
        self.last_R.copy_(pose_R)
        self.last_t.copy_(pose_t)
        entry = torch.cat([pose_R, pose_t[:, None]], dim=1)
        self._pose_log.index_copy_(0, self._pose_count, entry[None])
        self._pose_count.add_(1)
        for lev in used_levels(self.tcfg):
            inten, depth = pre.pyramid.intensity[lev], pre.pyramid.depth[lev]
            buf = self.prev_rows.get(lev)
            if buf is None or buf.shape[0] != inten.numel():
                buf = self.prev_rows[lev] = torch.empty(
                    (inten.numel(), 2), dtype=torch.float32, device=self.device)
            torch.stack([inten.reshape(-1), depth.reshape(-1)], dim=-1, out=buf)
        return torch.cat([pose_R.reshape(-1), pose_t, pre.drop_frac.reshape(1)])

    def _tracked_epilogue(self, pre):
        pose_R, pose_t = st.compose(self.last_R, self.last_t, self.gn.dR, self.gn.dt)
        rgb_weight, n_unstable = divergence_update(self.gn.iters, self.rgb_weight,
                                                   self.n_unstable)
        self.rgb_weight.copy_(rgb_weight)
        self.n_unstable.copy_(n_unstable)
        return self._finish(pre, pose_R, pose_t)

    def _track(self, rgb, depth, calib, depth_cut):
        """One tracked frame through the frame step of its calibration and
        format (captured anew when either changes, or the map's storage)."""
        rgb, depth = torch.as_tensor(rgb), torch.as_tensor(depth)
        key = (tuple(rgb.shape), rgb.dtype, tuple(depth.shape), depth.dtype,
               float(calib.fx), float(calib.fy), float(calib.cx), float(calib.cy),
               float(getattr(calib, "dscale", 1.0)), tuple(depth_cut),
               tuple(x.data_ptr() for x in self.map.state))
        if self._step is None or self._step.key != key:
            self._step = _FrameStep(self, rgb, depth, calib, depth_cut, key)
        self._step.rgb_in.copy_(rgb)
        self._step.depth_in.copy_(depth)
        return self._step.run()

    def track_camera(self, rgb, depth, calib, set_pose: Isometry = None,
                     depth_cut=(0.5, 5.0)):
        """Returns the device pose (R (3, 3), t (3,))."""
        self._spill_pose_log(1)
        if set_pose is not None:
            with trace.span("frontend.preprocess"):
                pre = self.preprocess(rgb, depth, calib, depth_cut)
            with trace.span("tracker.finish"):
                out = self._finish(
                    pre, torch.as_tensor(set_pose.q.rotation_matrix, dtype=torch.float32,
                                         device=self.device),
                    torch.as_tensor(set_pose.t, dtype=torch.float32, device=self.device))
        else:
            if self.n_tracked == 0:
                raise RuntimeError("first frame needs set_pose (first_iso)")
            out, pre = self._track(rgb, depth, calib, depth_cut)
            self.last_iters = self.gn.iters.clone()
        return self._record(out, pre)

    def _record(self, out, pre):
        """Book a frame's out (13,) or a block's (K, 13) and the last
        frame's ``Preprocessed``: one ``drop_fracs`` and one ``all_pd_pose``
        entry.  :return: the last pose."""
        last = out.reshape(-1, 13)[-1]
        pose = (last[:9].view(3, 3), last[9:12])
        self.last_processed_pc = (pre.points, pre.normals, pre.mask)
        self.last_colored_pcd = (pre.points, pre.colors, pre.mask)
        self.drop_fracs.append(out[..., 12])
        self.all_pd_pose.append(pose)
        self.n_tracked += out.reshape(-1, 13).shape[0]
        return pose

    def track_camera_block(self, rgb_k, depth_k, calib, depth_cut=(0.5, 5.0)):
        """K consecutive tracking-only frames sharing ``calib``, stacked
        (K, H, W[, 3]): K runs of the frame step (on the card K sets of graph
        replays) from the stack on the device.  All K poses land in the pose
        log; ``drop_fracs`` and ``all_pd_pose`` get one entry for the block
        (the (K,) drop fractions, the last pose).  :return: the last pose."""
        if self.n_tracked == 0:
            raise RuntimeError("block tracking needs a tracked or set first frame")
        K = int(rgb_k.shape[0])
        self._spill_pose_log(K)
        rgb_k = torch.as_tensor(rgb_k, device=self.device)
        depth_k = torch.as_tensor(depth_k, device=self.device)
        outs, iters = [], []
        for k in range(K):
            out, pre = self._track(rgb_k[k], depth_k[k], calib, depth_cut)
            outs.append(out)
            iters.append(self.gn.iters.clone())
        self.last_iters = torch.stack(iters)
        return self._record(torch.stack(outs), pre)

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
