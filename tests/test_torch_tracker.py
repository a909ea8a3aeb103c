"""Port's tracker terms and one GN step against the JAX package.

A frame pair of the 160x120 synthetic sequence, preprocessed by the JAX
frontend, and a map holding frame 0 integrated at its ground-truth pose
(both packages' maps agree exactly, see test_torch_map.py) feed both
trackers.  H, g and energy of the SDF and photometric terms agree to
rtol 1e-4 (f32 sums of ~1e4 residuals in another order); the staged GN
schedule gives the same iteration counts and the same pose to 1e-4.
"""

from pathlib import Path

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
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system import tracker as TT
from nerf_fusion_tpu_torch.system.frontend import Pyramid
from nerf_fusion_tpu_torch.utils import se3_torch as st
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[-3.0, -1.0, -3.0], bound_max=[3.0, 3.0, 3.0],
                voxel_size=0.1, prune_min_vox_obs=4, ignore_count_th=4.0,
                encoder_count_th=600.0, latent_capacity=4096, alloc_capacity=2048)
TRACK_ARGS = dict(
    iter_config=[{"n": 3, "type": [["rgb", 2]]},
                 {"n": 3, "type": [["sdf"], ["rgb", 1]]},
                 {"n": 4, "type": [["sdf"], ["rgb", 0]]}],
    sdf={"robust_kernel": "huber", "robust_k": 5.0, "subsample": 0.5},
    rgb={"weight": 500.0, "robust_kernel": None, "robust_k": 0.01,
         "min_grad_scale": 0.0, "max_depth_delta": 0.2, "stride": 2,
         "scale_intrinsics": True})


def _t(a):
    return torch.tensor(np.asarray(a))


def _tpyr(p):
    return Pyramid(*(tuple(_t(a) for a in level) for level in p))


@pytest.fixture(scope="module")
def setup():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    seq = SyntheticSequence(n_frames=10, width=160, height=120)
    f0, f1 = seq.render_frame(0), seq.render_frame(1)
    c = f0.calib
    kw = dict(outlier_radius=0.3, outlier_min_nb=6, normal_radius=0.4)
    p0 = jax_preprocess(jnp.asarray(f0.rgb), jnp.asarray(f0.depth), c.fx, c.fy, c.cx,
                        c.cy, 0.5, 5.0, 4096, **kw)
    p1 = jax_preprocess(jnp.asarray(f1.rgb), jnp.asarray(f1.depth), c.fx, c.fy, c.cx,
                        c.cy, 0.5, 5.0, 4096, **kw)
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
    targs = dict_to_args(TRACK_ARGS)
    return dict(jm=jm, tm=tm, c=c, p0=p0, p1=p1, R0=R0, t0=t0, jcfg=jcfg, tcfg=tcfg,
                js=js, ts=ts, jtc=JT.TrackerConfig.from_args(targs),
                ttc=TT.TrackerConfig.from_args(targs))


def _delta(seed):
    xi = (np.random.RandomState(seed).randn(6) * 0.005).astype(np.float32)
    jR, jt = sj.se3_exp(jnp.asarray(xi))
    return (jR, jt), (_t(jR), _t(jt))


def _assert_Hg(jres, tres, rtol=1e-4):
    for a, b in zip(jres, tres):
        a, b = np.asarray(a, np.float64), b.double().numpy()
        assert np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-12), (a, b)


def test_sdf_term_matches_jax(setup):
    s = setup
    (jR, jt), (tR, tt) = _delta(0)
    k = 2048
    pts, mask = s["p1"].points[:k], s["p1"].mask[:k]
    jres = JT._sdf_Hg(s["js"], s["jcfg"], s["jm"].decoder_params, s["jm"].decoder_config,
                      s["jtc"], jnp.asarray(s["R0"]), jnp.asarray(s["t0"]), jR, jt, pts, mask)
    tres = TT._sdf_Hg(s["ts"], s["tcfg"], s["tm"].decoder, s["ttc"], _t(s["R0"]),
                      _t(s["t0"]), tR, tt, _t(pts), _t(mask))
    assert float(tres[2]) > 0
    _assert_Hg(jres, tres)


@pytest.mark.parametrize("lev", [0, 1, 2])
def test_rgb_term_matches_jax(setup, lev):
    s = setup
    (jR, jt), (tR, tt) = _delta(1)
    c = s["c"]
    sc = 0.5 ** lev
    p0, p1 = s["p0"].pyramid, s["p1"].pyramid
    ld = (p0.intensity[lev], p0.depth[lev], p1.intensity[lev], p1.depth[lev],
          p1.gradient[lev])
    jres = JT._rgb_Hg(s["jtc"], ld, c.fx * sc, c.fy * sc, c.cx * sc, c.cy * sc, jR, jt,
                      jnp.asarray(500.0))
    tres = TT._rgb_Hg(s["ttc"], tuple(_t(a) for a in ld), c.fx * sc, c.fy * sc,
                      c.cx * sc, c.cy * sc, tR, tt, 500.0)
    _assert_Hg(jres, tres)


def test_motion_term_and_se3_match_jax(setup):
    s = setup
    (jR, jt), (tR, tt) = _delta(2)
    _assert_Hg(JT._motion_Hg(s["jtc"], jR, jt), TT._motion_Hg(s["ttc"], tR, tt))
    rng = np.random.RandomState(5)
    for scale in (1e-6, 0.3):
        xi = (rng.randn(4, 6) * scale).astype(np.float32)
        jRb, jtb = sj.se3_exp(jnp.asarray(xi))
        tRb, ttb = st.se3_exp(_t(xi))
        assert np.abs(tRb.numpy() - np.asarray(jRb)).max() < 1e-6
        assert np.abs(ttb.numpy() - np.asarray(jtb)).max() < 1e-6
        assert np.abs(st.so3_log(tRb).numpy() - np.asarray(sj.so3_log(jRb))).max() < 1e-5
        cR, ct = st.compose(tRb, ttb, tRb, ttb)
        jcR, jct = sj.compose(jRb, jtb, jRb, jtb)
        assert np.abs(cR.numpy() - np.asarray(jcR)).max() < 1e-6
        assert np.abs(ct.numpy() - np.asarray(jct)).max() < 1e-6
        p = rng.randn(10, 3).astype(np.float32)
        assert np.abs(st.transform_points(tRb[0], ttb[0], _t(p)).numpy() - np.asarray(
            sj.transform_points(jRb[0], jtb[0], jnp.asarray(p)))).max() < 1e-5


def test_gauss_newton_matches_jax(setup):
    s = setup
    c = s["c"]
    k = 2048
    pts, mask = s["p1"].points[:k], s["p1"].mask[:k]
    jR, jt, jiters = JT.track_gauss_newton(
        s["js"], s["jcfg"], s["jm"].decoder_params, s["jm"].decoder_config, s["jtc"],
        s["p0"].pyramid, s["p1"].pyramid, pts, mask, jnp.asarray(s["R0"]),
        jnp.asarray(s["t0"]), jnp.eye(3), jnp.zeros(3), c.fx, c.fy, c.cx, c.cy,
        jnp.asarray(500.0))
    tR, tt, titers = TT.track_gauss_newton(
        s["ts"], s["tcfg"], s["tm"].decoder, s["ttc"], _tpyr(s["p0"].pyramid),
        _tpyr(s["p1"].pyramid), _t(pts), _t(mask), _t(s["R0"]), _t(s["t0"]),
        torch.eye(3), torch.zeros(3), c.fx, c.fy, c.cx, c.cy, 500.0)
    assert list(np.asarray(jiters)) == titers
    assert np.abs(tR.numpy() - np.asarray(jR)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-4


def _tracker(capacity):
    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence as TorchSeq

    tm, _ = load_model(CKPT, 300)
    vmap = tmap.SparseVoxelMap(tm, dict_to_args(MAP_ARGS), 29, "cpu")
    tr = TT.SDFTracker(vmap, dict_to_args(TRACK_ARGS), point_budget=2048)
    tr.pose_log_capacity = capacity
    tr._pose_log = torch.zeros((capacity, 3, 4))
    return tr, TorchSeq(n_frames=8, width=64, height=48)


def test_pose_log_spills_to_host():
    """Past its capacity the device pose log spills to the host archive
    and restarts; the history keeps every pose in order."""
    tr, seq = _tracker(capacity=3)
    gts = []
    for i in range(7):
        f = seq.render_frame(i)
        tr.track_camera(f.rgb, f.depth, f.calib, set_pose=f.gt_pose)
        gts.append(f.gt_pose)
    hist = tr.pose_history()
    assert len(hist) == 7 and len(tr._pose_archive) == 2
    for h, g in zip(hist, gts):
        assert np.allclose(h.t, g.t, atol=1e-6)
        assert np.allclose(h.q.rotation_matrix, g.q.rotation_matrix, atol=1e-5)


def test_degenerate_frame_keeps_pose_finite():
    """A frame with no usable depth gives no valid residual: the GN step is
    non-finite or zero and the pose stays where it was."""
    tr, seq = _tracker(capacity=16)
    f0 = seq.render_frame(0)
    tr.track_camera(f0.rgb, f0.depth, f0.calib, set_pose=f0.gt_pose)
    bad = seq.render_frame(1)
    R, t = tr.track_camera(torch.zeros_like(bad.rgb), torch.full_like(bad.depth, float("nan")),
                           bad.calib)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    assert np.allclose(t.numpy(), np.asarray(f0.gt_pose.t, np.float32), atol=1e-6)
    good = seq.render_frame(2)
    R, t = tr.track_camera(good.rgb, good.depth, good.calib)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
