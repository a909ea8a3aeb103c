"""Port's tracker terms and one GN step against the JAX package.

A frame pair of the 160x120 synthetic sequence, preprocessed by the JAX
frontend, and a map holding frame 0 integrated at its ground-truth pose
(both packages' maps agree exactly, see test_torch_map.py) feed both
trackers.  H, g and energy of the SDF and photometric terms agree to
rtol 1e-4 (f32 sums of ~1e4 residuals in another order); the staged GN
schedule gives the same iteration counts and the same pose to 1e-4.
The sparse photometric term's pixel selection gives JAX's pixels exactly,
in JAX's order (a selection rounds nothing).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops import imgproc as JI
from nerf_fusion_tpu.system import map as jmap
from nerf_fusion_tpu.system import tracker as JT
from nerf_fusion_tpu.system.frontend import preprocess_frame as jax_preprocess
from nerf_fusion_tpu.utils import se3_jax as sj
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import imgproc as TI
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
    tld = tuple(_t(a) for a in ld)
    tres = TT._rgb_Hg(s["ttc"], (TI.intensity_depth_rows(*tld[:2]),) + tld[2:],
                      c.fx * sc, c.fy * sc, c.cx * sc, c.cy * sc, tR, tt, 500.0)
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
    assert list(np.asarray(jiters)) == titers.tolist()
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


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


def _select_both(level_planes, k, min_grad, stride):
    j = JI.select_photometric_pixels(*level_planes, k, min_grad, stride=stride)
    t = TI.select_photometric_pixels(*(_t(a) for a in level_planes), k, min_grad,
                                     stride=stride)
    return j, t


@pytest.mark.parametrize("lev,stride,k", [(0, 2, 1500), (0, 1, 4000), (1, 2, 1500),
                                          (2, 2, 1500), (1, 1, 10 ** 6)])
def test_select_photometric_pixels_matches_jax(setup, lev, stride, k):
    """Same pixels in the same order and the same gathered values; levels
    whose stride grid is smaller than k take every grid pixel."""
    p1 = setup["p1"].pyramid
    j, t = _select_both((p1.intensity[lev], p1.depth[lev], p1.gradient[lev]),
                        k, 0.0, stride)
    for a, b in zip(j, t):
        _same(b.numpy(), a)
    assert 0 < int(t[6].sum()) <= len(t[6])


@pytest.mark.parametrize("stride", [1, 2])
def test_selection_ties_taken_lowest_index_first(stride):
    """A plane of mostly equal scores: ``min_grad_scale = 0`` admits every
    flat pixel at score 0, and k cuts through the ties.  ``lax.top_k``
    takes equal scores lowest index first; so must the port."""
    rng = np.random.default_rng(3)
    h, w = 48, 64
    inten = rng.random((h, w)).astype(np.float32)
    depth = (1.0 + rng.random((h, w))).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = np.nan
    g = np.zeros((2, h, w), np.float32)
    hot = rng.random((h, w)) < 0.05
    g[:, hot] = rng.normal(size=(2, int(hot.sum()))).astype(np.float32)
    g[:, 0, :] = g[:, -1, :] = g[:, :, 0] = g[:, :, -1] = np.nan
    k = 1000 // stride ** 2
    j, t = _select_both((inten, depth, g), k, 0.0, stride)
    for a, b in zip(j, t):
        _same(b.numpy(), a)
    gx, gy = np.asarray(j[4]), np.asarray(j[5])
    assert (gx * gx + gy * gy == 0).sum() > k // 2      # the cut lies among the ties


def _level_args(s, lev):
    c = s["c"]
    sc = 0.5 ** lev
    p0, p1 = s["p0"].pyramid, s["p1"].pyramid
    ld = (p0.intensity[lev], p0.depth[lev], p1.intensity[lev], p1.depth[lev],
          p1.gradient[lev])
    return ld, (c.fx * sc, c.fy * sc, c.cx * sc, c.cy * sc)


@pytest.mark.parametrize("lev", [0, 1, 2])
def test_sparse_rgb_term_matches_jax(setup, lev):
    """``rgb_odometry_sparse`` on the same selection, and the sparse
    ``_rgb_Hg``: residuals and Jacobians to 1e-5 relative (elementwise f32
    in another fusion order), the validity mask exactly, H/g/energy to
    rtol 1e-4 as for the dense term."""
    s = setup
    (jR, jt), (tR, tt) = _delta(1)
    ld, (fx, fy, cx, cy) = _level_args(s, lev)
    jpix, tpix = _select_both(ld[2:], 1500, 0.0, 2)
    Hl, Wl = ld[2].shape
    jrows = jnp.stack([ld[0].reshape(-1), ld[1].reshape(-1)], -1)
    trows = _t(jrows)
    jK = jnp.asarray([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    jKinv = jnp.linalg.inv(jK)
    krkinv, kt = jK @ jR @ jKinv, jK @ jt
    jf, jJ, jok = JI.rgb_odometry_sparse(jrows, Wl, Hl, jpix, fx, fy, cx, cy, krkinv, kt,
                                         0.2)
    tf, tJ, tok = TI.rgb_odometry_sparse(trows, Wl, Hl, tpix, fx, fy, cx, cy, _t(krkinv),
                                         _t(kt), 0.2)
    assert np.array_equal(tok.numpy(), np.asarray(jok)) and int(tok.sum()) > 100
    for a, b in ((jf, tf), (jJ, tJ)):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()
    jres = JT._rgb_Hg(s["jtc"], None, fx, fy, cx, cy, jR, jt, jnp.asarray(500.0),
                      sparse=(jrows, Wl, Hl, jpix))
    tres = TT._rgb_Hg(s["ttc"], None, fx, fy, cx, cy, tR, tt, 500.0,
                      sparse=(trows, Wl, Hl, tpix))
    _assert_Hg(jres, tres)


@pytest.mark.parametrize("stride", [1, 2])
def test_sparse_equals_dense_when_budget_covers(setup, stride):
    """A budget that covers every grid pixel selects exactly the dense
    pixel set: H, g and energy agree (rtol 2e-4, atol 1e-5: the same sums
    in another order).  A real budget (a quarter of the grid) still gives
    a GN step pointing the same way (cos > 0.95)."""
    s = setup
    _, (tR, tt) = _delta(0)
    ld, (fx, fy, cx, cy) = _level_args(s, 0)
    ld = tuple(_t(a) for a in ld)
    targs = dict_to_args({**TRACK_ARGS, "rgb": {**TRACK_ARGS["rgb"], "stride": stride}})
    tcfg = TT.TrackerConfig.from_args(targs)
    rows = TI.intensity_depth_rows(ld[0], ld[1])
    Hd, gd, ed = TT._rgb_Hg(tcfg, (rows,) + ld[2:], fx, fy, cx, cy, tR, tt, 500.0)
    Hl, Wl = ld[2].shape
    n_grid = (Hl // stride) * (Wl // stride)
    res = {}
    for k in (n_grid, n_grid // 4):
        pix = TI.select_photometric_pixels(ld[2], ld[3], ld[4], k, 0.0, stride=stride)
        res[k] = TT._rgb_Hg(tcfg, None, fx, fy, cx, cy, tR, tt, 500.0,
                            sparse=(rows, Wl, Hl, pix))
    Hs, gs, es = res[n_grid]
    np.testing.assert_allclose(Hs.numpy(), Hd.numpy(), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), gd.numpy(), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(es), float(ed), rtol=2e-4)
    Hq, gq, _ = res[n_grid // 4]
    sd = np.linalg.solve(Hd.double().numpy() + 1e-9 * np.eye(6), -gd.double().numpy())
    sq = np.linalg.solve(Hq.double().numpy() + 1e-9 * np.eye(6), -gq.double().numpy())
    assert sd @ sq / (np.linalg.norm(sd) * np.linalg.norm(sq) + 1e-12) > 0.95


def test_gauss_newton_sparse_matches_jax(setup):
    """The staged schedule with ``rgb.pixel_budget``: the selection runs
    once per frame per level; same iteration counts, pose within 1e-4."""
    s = setup
    c = s["c"]
    k = 2048
    targs = dict_to_args({**TRACK_ARGS, "rgb": {**TRACK_ARGS["rgb"], "pixel_budget": 1500}})
    jtc, ttc = JT.TrackerConfig.from_args(targs), TT.TrackerConfig.from_args(targs)
    assert jtc.rgb_pixel_budget == ttc.rgb_pixel_budget == 1500
    pts, mask = s["p1"].points[:k], s["p1"].mask[:k]
    jR, jt, jiters = JT.track_gauss_newton(
        s["js"], s["jcfg"], s["jm"].decoder_params, s["jm"].decoder_config, jtc,
        s["p0"].pyramid, s["p1"].pyramid, pts, mask, jnp.asarray(s["R0"]),
        jnp.asarray(s["t0"]), jnp.eye(3), jnp.zeros(3), c.fx, c.fy, c.cx, c.cy,
        jnp.asarray(500.0))
    tR, tt, titers = TT.track_gauss_newton(
        s["ts"], s["tcfg"], s["tm"].decoder, ttc, _tpyr(s["p0"].pyramid),
        _tpyr(s["p1"].pyramid), _t(pts), _t(mask), _t(s["R0"]), _t(s["t0"]),
        torch.eye(3), torch.zeros(3), c.fx, c.fy, c.cx, c.cy, 500.0)
    assert list(np.asarray(jiters)) == titers.tolist()
    assert np.abs(tR.numpy() - np.asarray(jR)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-4


def test_last_iters_and_colored_pcd(setup):
    """``SDFTracker`` on the frame pair: ``last_iters`` (the GN evaluations
    of each group, kept on the device) equals JAX's per-group counts of the
    staged schedule on the same pair, and ``last_colored_pcd`` holds the
    frontend's points, colours and mask of the tracked frame."""
    from nerf_fusion_tpu_torch.system.frontend import preprocess_frame
    from nerf_fusion_tpu_torch.utils.se3 import Isometry

    s = setup
    c = s["c"]
    seq = SyntheticSequence(n_frames=10, width=160, height=120)
    f0, f1 = seq.render_frame(0), seq.render_frame(1)
    pre_kw = dict(outlier_radius=0.3, outlier_min_nb=6, normal_radius=0.4)
    vmap = tmap.SparseVoxelMap(s["tm"], dict_to_args(MAP_ARGS), 29, "cpu")
    vmap._assign(s["ts"])
    tr = TT.SDFTracker(vmap, dict_to_args({**TRACK_ARGS, "preprocess": pre_kw}),
                       point_budget=4096, gn_point_budget=2048)
    tr.track_camera(f0.rgb, f0.depth, c, set_pose=Isometry.from_matrix(
        s["R0"].astype(np.float64), s["t0"].astype(np.float64), ortho=True))
    assert tr.last_iters is None                  # a set pose runs no GN
    tr.track_camera(f1.rgb, f1.depth, c)
    k = 2048
    _, _, jiters = JT.track_gauss_newton(
        s["js"], s["jcfg"], s["jm"].decoder_params, s["jm"].decoder_config, s["jtc"],
        s["p0"].pyramid, s["p1"].pyramid, s["p1"].points[:k], s["p1"].mask[:k],
        jnp.asarray(s["R0"]), jnp.asarray(s["t0"]), jnp.eye(3), jnp.zeros(3),
        c.fx, c.fy, c.cx, c.cy, jnp.asarray(500.0))
    assert tr.last_iters.dtype == torch.int32
    assert tr.last_iters.tolist() == list(np.asarray(jiters))
    pts, colors, mask = tr.last_colored_pcd
    ref = preprocess_frame(torch.as_tensor(f1.rgb), torch.as_tensor(f1.depth), c.fx, c.fy,
                           c.cx, c.cy, 0.5, 5.0, 4096, **pre_kw)
    assert torch.equal(pts, ref.points) and torch.equal(mask, ref.mask)
    assert torch.equal(colors, ref.colors) and int(mask.sum()) > 100
    assert torch.equal(pts, tr.last_processed_pc[0])
