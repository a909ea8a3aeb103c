"""The GN loop with its state on the device against the host loop it
replaced, and against the JAX package.

The host loop read each evaluation's energy to the host and solved, guarded
and composed the step there; the loop now keeps (i, dR, dt, bR, bt, best
energy, done, used) in ``ops.gn.GNState``, runs ``gn_step`` (on the CPU its
plain version) once per evaluation and reads only the done flag.  On the
CPU that is the same arithmetic, so poses and ``iters_used`` are held
bitwise against a copy of the host loop (below), on the dense and the
sparse photometric term, the config's 10/10/50 schedule, a one-step
schedule and a frame with no usable depth.  Against JAX: the same
``iters_used`` and the pose to 1e-4, as ``test_torch_tracker.py`` holds the
loop.  The step alone is held against the JAX ``while_loop`` body
(``nerf_fusion_tpu/system/tracker.py:288-310``, copied below): the pose to
1e-5 of its largest entry (f32 LU in another library), the decisions
exactly, also for a singular H and a NaN energy.  The SDF term's explicit
chain to world coordinates equals the autograd chain it replaced bitwise.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.system import map as jmap
from nerf_fusion_tpu.system import tracker as JT
from nerf_fusion_tpu.system.frontend import preprocess_frame as jax_preprocess
from nerf_fusion_tpu.utils import se3_jax as sj
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import gn, imgproc, mlp, photometric
from nerf_fusion_tpu_torch.ops import voxel as vox
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system import tracker as TT
from nerf_fusion_tpu_torch.system.frontend import Pyramid
from nerf_fusion_tpu_torch.utils import se3_torch as st
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[-3.0, -1.0, -3.0], bound_max=[3.0, 3.0, 3.0],
                voxel_size=0.1, prune_min_vox_obs=4, ignore_count_th=4.0,
                encoder_count_th=600.0, latent_capacity=4096, alloc_capacity=2048)
RGB = {"weight": 500.0, "robust_kernel": None, "robust_k": 0.01, "min_grad_scale": 0.0,
       "max_depth_delta": 0.2, "stride": 2, "scale_intrinsics": True}
SDF = {"robust_kernel": "huber", "robust_k": 5.0, "subsample": 0.5}
SCHEDULES = {
    "config": [{"n": 10, "type": [["rgb", 2]]}, {"n": 10, "type": [["sdf"], ["rgb", 1]]},
               {"n": 50, "type": [["sdf"], ["rgb", 0]]}],
    "one_step": [{"n": 1, "type": [["rgb", 2]]}, {"n": 1, "type": [["sdf"], ["rgb", 1]]},
                 {"n": 1, "type": [["sdf"], ["rgb", 0]]}],
}
K_PTS = 2048


def _t(a):
    return torch.tensor(np.asarray(a))


def _tpyr(p):
    return Pyramid(*(tuple(_t(a) for a in level) for level in p))


def _args(schedule, budget=0, weight=500.0):
    return dict_to_args(dict(iter_config=SCHEDULES[schedule] if isinstance(schedule, str)
                             else schedule, sdf=SDF,
                             rgb={**RGB, "pixel_budget": budget, "weight": weight}))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the test processes run side by side (pytest-xdist)
    and the small shapes here gain nothing from a thread pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    seq = SyntheticSequence(n_frames=10, width=160, height=120)
    f0, f1 = seq.render_frame(0), seq.render_frame(1)
    c = f0.calib
    kw = dict(outlier_radius=0.3, outlier_min_nb=6, normal_radius=0.4)
    p0, p1 = (jax_preprocess(jnp.asarray(f.rgb), jnp.asarray(f.depth), c.fx, c.fy, c.cx,
                             c.cy, 0.5, 5.0, 4096, **kw) for f in (f0, f1))
    R0 = np.asarray(f0.gt_pose.q.rotation_matrix, np.float32)
    t0 = np.asarray(f0.gt_pose.t, np.float32)
    margs = dict_to_args(MAP_ARGS)
    jcfg = jmap.MapConfig.from_args(margs, 29)
    tcfg = tmap.MapConfig.from_args(margs, 29)
    js, _, _ = jmap.integrate_keyframe(
        jmap.init_state(jcfg), jcfg, jm.encoder_params, jm.encoder_bn,
        jm.encoder_config, p0.points, p0.normals, p0.mask, jnp.asarray(R0), jnp.asarray(t0))
    ts, _ = tmap.integrate_keyframe(
        tmap.init_state(tcfg, "cpu"), tcfg, tm.encoder, _t(p0.points), _t(p0.normals),
        _t(p0.mask), _t(R0), _t(t0))
    return dict(jm=jm, tm=tm, c=c, p0=p0, p1=p1, R0=R0, t0=t0, jcfg=jcfg, tcfg=tcfg,
                js=js, ts=ts)


class _SDFWithInputGrad(torch.autograd.Function):
    """The autograd route the tracker took before: the kernel's d sdf / d rel
    as the backward of sdf (std carries no gradient)."""

    @staticmethod
    def forward(ctx, rel, latent, decoder):
        x = torch.cat([latent.detach(), rel.detach()], dim=1).contiguous()
        out, grad = mlp.decoder_forward_grad(x, decoder.packed, decoder.mats)
        ctx.save_for_backward(grad)
        sdf, std = out[:, 0].contiguous(), out[:, 1].contiguous()
        ctx.mark_non_differentiable(std)
        return sdf, std

    @staticmethod
    def backward(ctx, grad_sdf, grad_std):
        (grad,) = ctx.saved_tensors
        return grad_sdf[:, None] * grad, None, None


def _sdf_Hg_autograd(state, cfg, decoder, tcfg, last_R, last_t, dR, dt, pts, mask):
    """The SDF term as it was: the position gradient by torch.autograd.grad."""
    p_delta = st.transform_points(dR, dt, pts)
    p_world = st.transform_points(last_R, last_t, p_delta).detach().requires_grad_(True)
    with torch.enable_grad():
        bound_min = torch.as_tensor(cfg.bound_min, dtype=torch.float32)
        xyz_norm = (p_world - bound_min[None, :]) / cfg.voxel_size
        grid = torch.ceil(xyz_norm.detach()).long() - 1
        inb = vox.in_bounds(grid, cfg.n_xyz)
        gid = vox.linearize_id(vox.clamp_grid(grid, cfg.n_xyz), cfg.n_xyz)
        slot = state.indexer.long()[gid]
        slot_c = slot.clamp(0, cfg.latent_capacity - 1)
        valid = inb & (slot >= 0) & (state.obs_count[slot_c] > cfg.ignore_count_th)
        rel = xyz_norm - grid.to(torch.float32) - 0.5
        sdf, std = _SDFWithInputGrad.apply(rel, state.latents[slot_c], decoder)
        r_g = sdf / std.detach()
        (dsdf_dpos,) = torch.autograd.grad(r_g, p_world, torch.ones_like(r_g))
    r = r_g.detach()
    m = (mask & valid).to(r.dtype)
    La = last_R.T @ dsdf_dpos.T
    q = p_delta.T
    Lb = torch.stack([q[1] * La[2] - q[2] * La[1], q[2] * La[0] - q[0] * La[2],
                      q[0] * La[1] - q[1] * La[0]], 0)
    J = torch.cat([La, Lb], dim=0)
    w = photometric.robust_weight(r, tcfg.sdf_robust_kernel, tcfg.sdf_robust_k) * m
    scale = 1.0 / torch.clamp_min(m.sum(), 1.0)
    return (((J * w[None, :]) @ J.T) * scale, (J @ (w * r)) * scale,
            torch.sum(r * (w * r)) * scale)


def _host_loop(map_state, map_cfg, decoder, tcfg, prev_pyr, cur_pyr, pts, mask, last_R,
               last_t, fx, fy, cx, cy, rgb_weight):
    """The GN loop before its state moved to the device: the energy read to
    the host per evaluation, the step solved and composed there."""
    used = {int(t[1]) if len(t) > 1 else 0
            for _, terms in tcfg.iter_config for t in terms if t[0] == "rgb"}
    prev_rows = {lev: imgproc.intensity_depth_rows(prev_pyr.intensity[lev],
                                                   prev_pyr.depth[lev]) for lev in used}
    scales = {lev: 0.5 ** lev if tcfg.scale_level_intrinsics else 1.0 for lev in used}
    sparse = {}
    if tcfg.rgb_pixel_budget > 0:
        for lev in sorted(used):
            pix = imgproc.select_photometric_pixels(
                cur_pyr.intensity[lev], cur_pyr.depth[lev], cur_pyr.gradient[lev],
                tcfg.rgb_pixel_budget, tcfg.min_grad_scale, stride=tcfg.rgb_stride)
            Hl, Wl = cur_pyr.intensity[lev].shape
            sparse[lev] = (prev_rows[lev], Wl, Hl, pix)

    def build_Hg(terms, dR, dt):
        H, g, energy = torch.zeros((6, 6)), torch.zeros(6), torch.zeros(())
        for term in terms:
            if term[0] == "sdf":
                Ht, gt, et = _sdf_Hg_autograd(map_state, map_cfg, decoder, tcfg, last_R,
                                              last_t, dR, dt, pts, mask)
            else:
                lev = int(term[1])
                s = scales[lev]
                Ht, gt, et = TT._rgb_Hg(tcfg, (prev_rows[lev], cur_pyr.intensity[lev],
                                               cur_pyr.depth[lev], cur_pyr.gradient[lev]),
                                        fx * s, fy * s, cx * s, cy * s, dR, dt, rgb_weight,
                                        sparse=sparse.get(lev))
            H, g, energy = H + Ht, g + gt, energy + et
        return H, g, energy

    eye6 = 1e-9 * torch.eye(6, dtype=torch.float32)
    dR, dt = torch.eye(3), torch.zeros(3)
    iters_used = []
    for n_iters, terms in tcfg.iter_config:
        bR, bt = dR, dt
        last_energy = float("inf")
        used = 0
        i = 0
        while i <= n_iters:
            H, g, energy = build_Hg(terms, dR, dt)
            e = float(energy)
            if not (e <= last_energy) or not np.isfinite(e):
                dR, dt = bR, bt
                break
            bR, bt, last_energy, used = dR, dt, e, i
            if i < n_iters:
                xi, _ = torch.linalg.solve_ex(H + eye6, -g)
                xi = torch.where(torch.isfinite(xi).all(), xi, torch.zeros_like(xi))
                eR, et = st.se3_exp(xi)
                dR, dt = st.compose(eR, et, dR, dt)
            i += 1
        iters_used.append(used)
    return dR, dt, iters_used


def _frame(s, degenerate=False):
    """(prev pyramid, cur pyramid, pts, mask) as port tensors."""
    prev, cur = _tpyr(s["p0"].pyramid), _tpyr(s["p1"].pyramid)
    pts, mask = _t(s["p1"].points[:K_PTS]), _t(s["p1"].mask[:K_PTS])
    if degenerate:
        nan = [torch.full_like(d, float("nan")) for d in cur.depth]
        cur = cur._replace(depth=tuple(nan))
        mask = torch.zeros_like(mask)
    return prev, cur, pts, mask


@pytest.mark.parametrize("schedule,budget,degenerate", [
    ("config", 0, False), ("config", 1500, False), ("one_step", 0, False),
    ("one_step", 1500, False), ("config", 0, True), ("config", 1500, True)])
def test_device_state_loop_is_the_host_loop(setup, schedule, budget, degenerate):
    s, c = setup, setup["c"]
    tcfg = TT.TrackerConfig.from_args(_args(schedule, budget))
    prev, cur, pts, mask = _frame(s, degenerate)
    args = (s["ts"], s["tcfg"], s["tm"].decoder, tcfg, prev, cur, pts, mask, _t(s["R0"]),
            _t(s["t0"]))
    n0 = gn.gn_step.launches
    dR, dt, iters = TT.track_gauss_newton(*args, torch.eye(3), torch.zeros(3), c.fx, c.fy,
                                          c.cx, c.cy, 500.0)
    rR, rt, riters = _host_loop(*args, c.fx, c.fy, c.cx, c.cy, 500.0)
    assert iters.dtype == torch.int32 and iters.tolist() == riters
    assert torch.equal(dR, rR) and torch.equal(dt, rt)
    assert gn.gn_step.launches == n0        # the CPU takes the plain version
    if degenerate:
        assert torch.equal(dR, torch.eye(3)) and torch.equal(dt, torch.zeros(3))


def test_step_hook_sees_every_evaluation(setup):
    """``track_gauss_newton``'s ``step`` hook (how the card's check records
    a real frame's steps) is called once per evaluation, group by group,
    and a hook that calls ``gn.gn_step`` leaves the result as it was."""
    s, c = setup, setup["c"]
    tcfg = TT.TrackerConfig.from_args(_args("one_step", 1500))
    prev, cur, pts, mask = _frame(s)
    args = (s["ts"], s["tcfg"], s["tm"].decoder, tcfg, prev, cur, pts, mask, _t(s["R0"]),
            _t(s["t0"]), torch.eye(3), torch.zeros(3), c.fx, c.fy, c.cx, c.cy, 500.0)
    seen = []

    def record(H, g, energy, state, group, n_iters):
        seen.append((group, n_iters, H.shape, g.shape, energy.shape))
        gn.gn_step(H, g, energy, state, group, n_iters)

    dR, dt, iters = TT.track_gauss_newton(*args, step=record)
    rR, rt, riters = TT.track_gauss_newton(*args)
    assert torch.equal(dR, rR) and torch.equal(dt, rt) and torch.equal(iters, riters)
    # the one-step schedule: two evaluations a group, the second ends it by count
    assert [x[:2] for x in seen] == [(0, 1), (0, 1), (1, 1), (1, 1), (2, 1), (2, 1)]
    assert all(x[2:] == ((6, 6), (6,), ()) for x in seen)


@pytest.mark.parametrize("schedule,budget", [("config", 0), ("one_step", 1500)])
def test_device_state_loop_matches_jax(setup, schedule, budget):
    s, c = setup, setup["c"]
    targs = _args(schedule, budget)
    jtc, ttc = JT.TrackerConfig.from_args(targs), TT.TrackerConfig.from_args(targs)
    pts, mask = s["p1"].points[:K_PTS], s["p1"].mask[:K_PTS]
    jR, jt, jiters = JT.track_gauss_newton(
        s["js"], s["jcfg"], s["jm"].decoder_params, s["jm"].decoder_config, jtc,
        s["p0"].pyramid, s["p1"].pyramid, pts, mask, jnp.asarray(s["R0"]),
        jnp.asarray(s["t0"]), jnp.eye(3), jnp.zeros(3), c.fx, c.fy, c.cx, c.cy,
        jnp.asarray(500.0))
    tR, tt, titers = TT.track_gauss_newton(
        s["ts"], s["tcfg"], s["tm"].decoder, ttc, _tpyr(s["p0"].pyramid),
        _tpyr(s["p1"].pyramid), _t(pts), _t(mask), _t(s["R0"]), _t(s["t0"]),
        torch.eye(3), torch.zeros(3), c.fx, c.fy, c.cx, c.cy, torch.tensor(500.0))
    assert list(np.asarray(jiters)) == titers.tolist()
    assert np.abs(tR.numpy() - np.asarray(jR)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-4


def test_explicit_sdf_chain_is_the_autograd_chain(setup):
    s = setup
    xi = (np.random.RandomState(0).randn(6) * 0.005).astype(np.float32)
    dR, dt = st.se3_exp(torch.tensor(xi))
    tcfg = TT.TrackerConfig.from_args(_args("config"))
    _, _, pts, mask = _frame(s)
    args = (s["ts"], s["tcfg"], s["tm"].decoder, tcfg, _t(s["R0"]), _t(s["t0"]), dR, dt,
            pts, mask)
    new, old = TT._sdf_Hg(*args), _sdf_Hg_autograd(*args)
    assert float(old[2]) > 0
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    bound_min = torch.tensor(s["tcfg"].bound_min)
    for a, b in zip(TT._sdf_Hg(*args, bound_min=bound_min), old):
        assert torch.equal(a, b)


def _jax_body(state, H, g, energy, n_iters):
    """``nerf_fusion_tpu/system/tracker.py:288-310`` with the evaluation given."""
    i, dR, dt, bR, bt, last_energy, done, used = state
    worse = (energy > last_energy) | ~jnp.isfinite(energy)
    bR2 = jnp.where(worse, bR, dR)
    bt2 = jnp.where(worse, bt, dt)
    best_energy = jnp.where(worse, last_energy, energy)
    xi = jnp.linalg.solve(H + 1e-9 * jnp.eye(6), -g)
    xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
    eR, et = sj.se3_exp(xi)
    nR, nt = sj.compose(eR, et, dR, dt)
    do_update = (~worse) & (i < n_iters)
    dR2 = jnp.where(do_update, nR, bR2)
    dt2 = jnp.where(do_update, nt, bt2)
    used2 = jnp.where(worse, used, i)
    return (i + 1, dR2, dt2, bR2, bt2, best_energy, worse, used2)


def _case(kind, rng):
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = (A @ A.T + 0.1 * np.eye(6)).astype(np.float32) * np.float32(50.0)
    g = (rng.normal(size=6) * 0.5).astype(np.float32)
    energy, best, i = np.float32(0.7), np.float32(0.9), 2
    if kind == "singular":
        H = np.ones((6, 6), np.float32)          # + 1e-9 I is lost in f32
    elif kind == "nan_energy":
        energy = np.float32(np.nan)
    elif kind == "worse":
        energy = np.float32(1.1)
    elif kind == "last_step":
        i = 4
    elif kind == "first":
        best, i = np.float32(np.inf), 0
    xi0 = (rng.normal(size=6) * 0.01).astype(np.float32)
    dR, dt = (np.asarray(a) for a in sj.se3_exp(jnp.asarray(xi0)))
    xi1 = (rng.normal(size=6) * 0.01).astype(np.float32)
    bR, bt = (np.asarray(a) for a in sj.se3_exp(jnp.asarray(xi1)))
    return H, g, energy, best, i, dR, dt, bR, bt


@pytest.mark.parametrize("kind", ["plain", "first", "singular", "nan_energy", "worse",
                                  "last_step"])
def test_gn_step_plain_matches_jax_body(kind):
    n_iters, used = 4, 1
    rng = np.random.default_rng(["plain", "first", "singular", "nan_energy", "worse",
                                 "last_step"].index(kind))
    H, g, energy, best, i, dR, dt, bR, bt = _case(kind, rng)
    with jax.default_matmul_precision("highest"):
        out = _jax_body((jnp.asarray(i), jnp.asarray(dR), jnp.asarray(dt), jnp.asarray(bR),
                         jnp.asarray(bt), jnp.asarray(best), jnp.asarray(False),
                         jnp.asarray(used)), jnp.asarray(H), jnp.asarray(g),
                        jnp.asarray(energy), n_iters)
    state = gn.new_state(3, "cpu")
    state.pose.copy_(torch.cat([_t(dR).reshape(-1), _t(dt), _t(bR).reshape(-1), _t(bt),
                                torch.tensor([best])]))
    state.ints.copy_(torch.tensor([i, used], dtype=torch.int32))
    gn.gn_step(_t(H), _t(g), torch.tensor(energy), state, 1, n_iters)
    ji, jdR, jdt, jbR, jbt, jbest, jdone, jused = (np.asarray(a) for a in out)
    finished = bool(jdone) or int(ji) > n_iters
    assert bool(state.done) == bool(jdone)
    assert int(state.iters[1]) == int(jused)
    assert state.ints.tolist() == ([0, 0] if finished else [int(ji), int(jused)])
    assert float(state.pose[24]) == (np.inf if finished else float(jbest))
    for got, ref in ((state.dR, jdR), (state.dt, jdt), (state.pose[12:21].view(3, 3), jbR),
                     (state.pose[21:24], jbt)):
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)
    if kind == "singular":      # a non-finite step keeps the pose
        assert np.array_equal(state.dR.numpy(), dR) and not bool(state.done)
    if kind in ("nan_energy", "worse"):
        assert bool(state.done) and np.array_equal(state.dR.numpy(), bR)


def test_divergence_state_machine_matches_jax(setup):
    """A motion-only group of 12 steps accepts every step (the prior's
    energy stays 0), so each frame ends with iters[-1] = 12 >= 10: the third
    frame raises the rgb weight from 100 to 500, in both packages."""
    s, c = setup, setup["c"]
    targs = _args([{"n": 12, "type": [["motion"]]}], weight=100.0)
    jtc, ttc = JT.TrackerConfig.from_args(targs), TT.TrackerConfig.from_args(targs)
    pts, mask = s["p1"].points[:K_PTS], s["p1"].mask[:K_PTS]
    jw, jn = jnp.asarray(100.0, jnp.float32), jnp.asarray(0, jnp.int32)
    tw, tn = torch.tensor(100.0), torch.tensor(0, dtype=torch.int32)
    seen = []
    for _ in range(4):
        jR, jt, jw, jn, jiters = JT.track_and_update(
            s["js"], s["jcfg"], s["jm"].decoder_params, s["jm"].decoder_config, jtc,
            s["p0"].pyramid, s["p1"].pyramid, pts, mask, jnp.asarray(s["R0"]),
            jnp.asarray(s["t0"]), c.fx, c.fy, c.cx, c.cy, jw, jn)
        dR, dt, titers = TT.track_gauss_newton(
            s["ts"], s["tcfg"], s["tm"].decoder, ttc, _tpyr(s["p0"].pyramid),
            _tpyr(s["p1"].pyramid), _t(pts), _t(mask), _t(s["R0"]), _t(s["t0"]),
            torch.eye(3), torch.zeros(3), c.fx, c.fy, c.cx, c.cy, tw)
        tR, tt = st.compose(_t(s["R0"]), _t(s["t0"]), dR, dt)
        tw, tn = TT.divergence_update(titers, tw, tn)
        assert titers.tolist() == list(np.asarray(jiters)) == [12]
        assert int(tn) == int(jn) and float(tw) == float(jw)
        assert np.abs(tR.numpy() - np.asarray(jR)).max() < 1e-6
        seen.append((int(tn), float(tw)))
    assert seen == [(1, 100.0), (2, 100.0), (3, 500.0), (4, 500.0)]


def test_tracker_keeps_the_state_machine_on_the_device():
    """The same schedule through ``SDFTracker``: its rgb weight and unstable
    count are device tensors that the epilogue updates in place."""
    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence as TorchSeq

    tm, _ = load_model(CKPT, 300)
    vmap = tmap.SparseVoxelMap(tm, dict_to_args(MAP_ARGS), 29, "cpu")
    tr = TT.SDFTracker(vmap, _args([{"n": 12, "type": [["motion"]]}], weight=100.0),
                       point_budget=2048)
    seq = TorchSeq(n_frames=5, width=64, height=48)
    w, n = tr.rgb_weight, tr.n_unstable
    f = seq.render_frame(0)
    tr.track_camera(f.rgb, f.depth, f.calib, set_pose=f.gt_pose)
    seen = []
    for k in range(1, 5):
        f = seq.render_frame(k)
        tr.track_camera(f.rgb, f.depth, f.calib)
        seen.append((int(tr.n_unstable), float(tr.rgb_weight), tr.gn.iters.tolist()))
    assert tr.rgb_weight is w and tr.n_unstable is n
    assert seen == [(1, 100.0, [12]), (2, 100.0, [12]), (3, 500.0, [12]), (4, 500.0, [12])]
    assert tr.host_reads == 4 * 12 and tr.graph_replays == 0
