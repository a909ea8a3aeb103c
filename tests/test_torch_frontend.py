"""Port's ``preprocess_frame`` and image ops against the JAX package.

The same rendered frame (JAX ``SyntheticSequence``, 160x120) goes through
both frontends.  Masks and the box filter's cell order must agree
exactly (the tracker takes the first ``gn_point_budget`` rows); float
fields agree to f32 rounding of differently ordered sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.ops import imgproc as jimg
from nerf_fusion_tpu.system.frontend import preprocess_frame as jax_preprocess
from nerf_fusion_tpu_torch.ops import imgproc
from nerf_fusion_tpu_torch.system.frontend import preprocess_frame

KW = dict(depth_cut_min=0.5, depth_cut_max=5.0, point_budget=8192, subsample=0.5,
          outlier_radius=0.3, outlier_min_nb=6, normal_radius=0.4)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(n_frames=2, width=160, height=120)
    f = seq.render_frame(0)
    c = f.calib
    rgb, depth = np.asarray(f.rgb, np.float32), np.asarray(f.depth, np.float32)
    pj = jax_preprocess(jnp.asarray(rgb), jnp.asarray(depth), c.fx, c.fy, c.cx, c.cy, **KW)
    pt = preprocess_frame(_t(rgb), _t(depth), c.fx, c.fy, c.cx, c.cy, **KW)
    return pj, pt


def _close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(a)
    assert np.abs(a[m] - b[m]).max(initial=0.0) <= atol


def test_pyramid(frames):
    pj, pt = frames
    for lev in range(3):
        # resampling matmuls: f32 summation order only
        _close(pj.pyramid.intensity[lev], pt.pyramid.intensity[lev].numpy(), 1e-6)
        _close(pj.pyramid.depth[lev], pt.pyramid.depth[lev].numpy(), 0.0)
        _close(pj.pyramid.gradient[lev], pt.pyramid.gradient[lev].numpy(), 1e-6)


def test_points_mask_and_order(frames):
    pj, pt = frames
    assert np.array_equal(np.asarray(pj.mask), pt.mask.numpy())
    m = np.asarray(pj.mask)
    assert m.sum() > 200
    # same cells in the same order: per-cell means agree to f32 rounding
    _close(np.asarray(pj.points)[m], pt.points.numpy()[m], 1e-6)
    _close(np.asarray(pj.colors)[m], pt.colors.numpy()[m], 1e-6)
    dots = np.sum(np.asarray(pj.normals)[m] * pt.normals.numpy()[m], -1)
    assert np.mean(dots > 0.999) > 0.99
    assert float(pt.drop_frac) == float(pj.drop_frac)


def test_unproject_gradient_resize():
    rng = np.random.RandomState(0)
    d = rng.uniform(0.5, 4.0, (48, 64)).astype(np.float32)
    d[rng.rand(48, 64) < 0.1] = np.nan
    i = rng.rand(48, 64).astype(np.float32)
    _close(jimg.unproject_depth(jnp.asarray(d), 50.0, 51.0, 31.5, 23.5),
           imgproc.unproject_depth(_t(d), 50.0, 51.0, 31.5, 23.5).numpy(), 0.0)
    _close(jimg.gradient_xy(jnp.asarray(i)), imgproc.gradient_xy(_t(i)).numpy(), 1e-6)
    _close(jimg.resize_half_bilinear(jnp.asarray(i)),
           imgproc.resize_half_bilinear(_t(i)).numpy(), 1e-6)
    _close(jimg.resize_half_nearest(jnp.asarray(d)),
           imgproc.resize_half_nearest(_t(d)).numpy(), 0.0)


def test_box_filter_order_with_int32_wrap():
    """Cell ids whose mixed key wraps around int32 come out in the JAX
    two-key sort order (valid first, then the wrapped key, ties by input
    position), and truncation at capacity drops the same tail."""
    rng = np.random.RandomState(1)
    n = 3000
    pts = rng.uniform(-7.9, 7.9, (n, 3)).astype(np.float32)
    pts[::3] = pts[1::3][: len(pts[::3])]          # shared cells
    nrm = rng.randn(n, 3).astype(np.float32)
    valid = rng.rand(n) > 0.2
    for cap in (4096, 1000):
        jp, jn, jm, jd = jimg.box_filter_points_exact(
            jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid), 0.02, cap)
        tp, tn, tm, td = imgproc.box_filter_points_exact(
            _t(pts), _t(nrm), _t(valid), 0.02, cap)
        assert np.array_equal(np.asarray(jm), tm.numpy())
        _close(jp, tp.numpy(), 1e-6)
        _close(jn, tn.numpy(), 1e-6)
        assert abs(float(jd) - float(td)) < 1e-7


def test_rgb_odometry_stride2():
    seq = SyntheticSequence(n_frames=2, width=160, height=120)
    f0, f1 = seq.render_frame(0), seq.render_frame(1)
    c = f0.calib
    rng = np.random.RandomState(2)
    i0, i1 = (np.asarray(f.rgb, np.float32).mean(-1) for f in (f0, f1))
    d0, d1 = (np.asarray(f.depth, np.float32) for f in (f0, f1))
    g1 = np.asarray(jimg.gradient_xy(jnp.asarray(i1)))
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]], np.float32)
    krkinv = (K @ (np.eye(3) + 0.01 * rng.randn(3, 3)) @ np.linalg.inv(K)).astype(np.float32)
    kt = (K @ (0.01 * rng.randn(3))).astype(np.float32)
    args = (c.fx, c.fy, c.cx, c.cy)
    fj, Jj, okj = jimg.rgb_odometry(jnp.asarray(i0), jnp.asarray(d0), jnp.asarray(i1),
                                    jnp.asarray(d1), jnp.asarray(g1), *args,
                                    jnp.asarray(krkinv), jnp.asarray(kt), 0.0, 0.2,
                                    stride=2)
    ft, Jt, okt = imgproc.rgb_odometry(imgproc.intensity_depth_rows(_t(i0), _t(d0)),
                                       _t(i1), _t(d1), _t(g1), *args,
                                       _t(krkinv), _t(kt), 0.0, 0.2, stride=2)
    assert np.array_equal(np.asarray(okj), okt.numpy())
    _close(fj, ft.numpy(), 1e-6)
    _close(Jj, Jt.numpy(), 1e-3 * max(1.0, float(np.abs(np.asarray(Jj)).max())))
