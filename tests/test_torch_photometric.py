"""The tracker's photometric term (``ops.photometric``) against the JAX package.

A frame pair of the 160x120 synthetic sequence, preprocessed by the JAX
frontend, goes through the JAX tracker's ``_rgb_Hg`` and the port's
``photometric_hg_plain`` (the CPU path and the card kernel's reference):
levels 0, 1 and 2; the dense term at stride 1 and 2 and the sparse term
(a 1500-pixel selection); robust kernels none, huber and tukey.

Tolerances: H, g and the energy within 1e-4 of each output's largest
|entry| (f32 sums of up to ~1e4 residuals in another order; JAX builds
K^-1 in float64 and rounds it, the port in f32); the valid count exactly,
against JAX's ``rgb_odometry`` / ``rgb_odometry_sparse`` mask on the same
K R K^-1 and K t.  The port's ``_rgb_Hg`` on the CPU is bitwise equal to
the composition it had before the kernel (copied below), whether K is
built per call or once per level and passed in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.ops import imgproc as JI
from nerf_fusion_tpu.system import tracker as JT
from nerf_fusion_tpu.system.frontend import preprocess_frame as jax_preprocess
from nerf_fusion_tpu.utils import se3_jax as sj
from nerf_fusion_tpu_torch.ops import imgproc as TI
from nerf_fusion_tpu_torch.ops import photometric as P
from nerf_fusion_tpu_torch.system import tracker as TT
from nerf_fusion_tpu_torch.utils.config import dict_to_args

RTOL = 1e-4
MIN_GRAD = 1e-4
ROBUST_K = {None: 0.01, "huber": 0.02, "tukey": 0.1}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(n_frames=10, width=160, height=120)
    f0, f1 = seq.render_frame(0), seq.render_frame(1)
    c = f0.calib
    kw = dict(outlier_radius=0.3, outlier_min_nb=6, normal_radius=0.4)
    p0 = jax_preprocess(jnp.asarray(f0.rgb), jnp.asarray(f0.depth), c.fx, c.fy, c.cx,
                        c.cy, 0.5, 5.0, 4096, **kw)
    p1 = jax_preprocess(jnp.asarray(f1.rgb), jnp.asarray(f1.depth), c.fx, c.fy, c.cx,
                        c.cy, 0.5, 5.0, 4096, **kw)
    xi = (np.random.RandomState(1).randn(6) * 0.005).astype(np.float32)
    jR, jt = sj.se3_exp(jnp.asarray(xi))
    return dict(c=c, p0=p0.pyramid, p1=p1.pyramid, jR=jR, jt=jt)


def _configs(stride, robust):
    args = dict_to_args(dict(
        iter_config=[{"n": 1, "type": [["rgb", 0]]}],
        sdf={"robust_kernel": None, "robust_k": 1.0, "subsample": 0.5},
        rgb={"weight": 500.0, "robust_kernel": robust, "robust_k": ROBUST_K[robust],
             "min_grad_scale": MIN_GRAD, "max_depth_delta": 0.2, "stride": stride,
             "scale_intrinsics": True}))
    return JT.TrackerConfig.from_args(args), TT.TrackerConfig.from_args(args)


def _level(fr, lev):
    sc = 0.5 ** lev
    c = fr["c"]
    ld = (fr["p0"].intensity[lev], fr["p0"].depth[lev], fr["p1"].intensity[lev],
          fr["p1"].depth[lev], fr["p1"].gradient[lev])
    return ld, (c.fx * sc, c.fy * sc, c.cx * sc, c.cy * sc)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a - b).max() <= RTOL * max(np.abs(a).max(), 1e-12), (a, b)


@pytest.mark.parametrize("robust", [None, "huber", "tukey"])
@pytest.mark.parametrize("variant", ["dense1", "dense2", "sparse"])
@pytest.mark.parametrize("lev", [0, 1, 2])
def test_plain_matches_jax_rgb_Hg(frames, lev, variant, robust):
    stride = 1 if variant == "dense1" else 2
    jtc, ttc = _configs(stride, robust)
    ld, (fx, fy, cx, cy) = _level(frames, lev)
    Hl, Wl = ld[2].shape
    jR, jt = frames["jR"], frames["jt"]
    tR, tt = _t(jR), _t(jt)
    jrows = jnp.stack([ld[0].reshape(-1), ld[1].reshape(-1)], -1)
    trows = _t(jrows)
    K, Kinv = TT._intrinsics(fx, fy, cx, cy, "cpu")
    krkinv, kt = K @ tR @ Kinv, K @ tt
    if variant == "sparse":
        jpix = JI.select_photometric_pixels(*ld[2:], 1500, MIN_GRAD, stride=2)
        tpix = TI.select_photometric_pixels(*(_t(a) for a in ld[2:]), 1500, MIN_GRAD,
                                            stride=2)
        jres = JT._rgb_Hg(jtc, None, fx, fy, cx, cy, jR, jt, jnp.asarray(500.0),
                          sparse=(jrows, Wl, Hl, jpix))
        _, _, jok = JI.rgb_odometry_sparse(jrows, Wl, Hl, jpix, fx, fy, cx, cy,
                                           jnp.asarray(krkinv.numpy()),
                                           jnp.asarray(kt.numpy()), 0.2)
        level = P.Sparse(Wl, Hl, tpix)
    else:
        jres = JT._rgb_Hg(jtc, ld, fx, fy, cx, cy, jR, jt, jnp.asarray(500.0))
        _, _, jok = JI.rgb_odometry(*ld, fx, fy, cx, cy, jnp.asarray(krkinv.numpy()),
                                    jnp.asarray(kt.numpy()), MIN_GRAD, 0.2, stride=stride)
        level = P.Dense(*(_t(a) for a in ld[2:]))
    H, g, e, count = P.photometric_hg_plain(
        trows, level, krkinv, kt, fx, fy, cx, cy, min_grad_scale=MIN_GRAD,
        max_depth_delta=0.2, stride=stride, robust_kernel=robust,
        robust_k=ROBUST_K[robust], rgb_weight=500.0)
    assert int(count) == int(np.asarray(jok).sum()) > 50
    for a, b in zip(jres, (H, g, e)):
        _close(a, b.numpy())
    assert float(e) > 0


def _rgb_Hg_before(tcfg, level_data, fx, fy, cx, cy, dR, dt, rgb_weight, sparse=None):
    """The port's ``tracker._rgb_Hg`` before the photometric kernel."""
    K, Kinv = TT._intrinsics(fx, fy, cx, cy, dR.device)
    krkinv = K @ dR @ Kinv
    kt = K @ dt
    if sparse is not None:
        prev_rows, W, H_, pix = sparse
        f, J, ok = TI.rgb_odometry_sparse(prev_rows, W, H_, pix, fx, fy, cx, cy,
                                          krkinv, kt, tcfg.max_depth_delta)
    else:
        prev_rows, cur_i, cur_d, cur_g = level_data
        f, J, ok = TI.rgb_odometry(prev_rows, cur_i, cur_d, cur_g,
                                   fx, fy, cx, cy, krkinv, kt,
                                   tcfg.min_grad_scale, tcfg.max_depth_delta,
                                   stride=tcfg.rgb_stride)
    J = -J
    m = ok.to(f.dtype)
    w = P.robust_weight(f, tcfg.rgb_robust_kernel, tcfg.rgb_robust_k) * m
    scale = rgb_weight / torch.clamp_min(m.sum(), 1.0)
    J2, f2, w2 = J.reshape(6, -1), f.reshape(-1), w.reshape(-1)
    H = ((J2 * w2[None]) @ J2.T) * scale
    g = (J2 @ (w2 * f2)) * scale
    energy = torch.sum(f2 * (w2 * f2)) * scale
    return H, g, energy


@pytest.mark.parametrize("variant,robust", [("dense1", "tukey"), ("dense2", None),
                                            ("sparse", "huber")])
def test_rgb_Hg_on_cpu_is_bitwise_the_composition_before(frames, variant, robust):
    stride = 1 if variant == "dense1" else 2
    _, ttc = _configs(stride, robust)
    ld, (fx, fy, cx, cy) = _level(frames, 0)
    ld = tuple(_t(a) for a in ld)
    tR, tt = _t(frames["jR"]), _t(frames["jt"])
    rows = TI.intensity_depth_rows(ld[0], ld[1])
    level_data = (rows,) + ld[2:]
    sparse = None
    if variant == "sparse":
        Hl, Wl = ld[2].shape
        sparse = (rows, Wl, Hl, TI.select_photometric_pixels(*ld[2:], 1500, MIN_GRAD,
                                                              stride=2))
    before = _rgb_Hg_before(ttc, level_data, fx, fy, cx, cy, tR, tt, 500.0, sparse)
    n0 = P.photometric_hg.launches
    for K in (None, TT._intrinsics(fx, fy, cx, cy, "cpu")):
        now = TT._rgb_Hg(ttc, level_data, fx, fy, cx, cy, tR, tt, 500.0, sparse, K=K)
        for a, b in zip(before, now):
            assert torch.equal(a, b)
    assert P.photometric_hg.launches == n0


@pytest.mark.parametrize("variant", ["dense1", "dense2", "sparse"])
def test_degenerate_level_gives_zero_normal_equations(frames, variant):
    """No valid pixel (the current depth all NaN): the count is 0, so the
    scale is rgb_weight / max(0, 1) = rgb_weight (finite: H is 0, not NaN),
    and H, g and the energy are exactly 0."""
    stride = 1 if variant == "dense1" else 2
    ld, (fx, fy, cx, cy) = _level(frames, 1)
    ld = tuple(_t(a) for a in ld)
    cur_d = torch.full_like(ld[3], float("nan"))
    rows = TI.intensity_depth_rows(ld[0], ld[1])
    tR, tt = _t(frames["jR"]), _t(frames["jt"])
    K, Kinv = TT._intrinsics(fx, fy, cx, cy, "cpu")
    if variant == "sparse":
        Hl, Wl = ld[2].shape
        level = P.Sparse(Wl, Hl, TI.select_photometric_pixels(ld[2], cur_d, ld[4], 500,
                                                              MIN_GRAD, stride=2))
        assert not level.pix[6].any()
    else:
        level = P.Dense(ld[2], cur_d, ld[4])
    H, g, e, count = P.photometric_hg(rows, level, K @ tR @ Kinv, K @ tt, fx, fy, cx, cy,
                                      min_grad_scale=MIN_GRAD, max_depth_delta=0.2,
                                      stride=stride, robust_kernel="huber", robust_k=0.02,
                                      rgb_weight=500.0)
    assert float(count) == 0.0
    assert torch.equal(H, torch.zeros(6, 6)) and torch.equal(g, torch.zeros(6))
    assert float(e) == 0.0
