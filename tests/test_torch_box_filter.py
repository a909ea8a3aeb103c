"""The port's hash box filter against the JAX package's ``box_filter_points``.

On the fixtures of ``tests/test_box_filter.py`` (and a frame through both
frontends with ``box_filter_exact: false``): the slot of every point, the
ownership table, the kept points, the cell order, the mask and
``drop_frac`` equal; points, normals and colors within 1e-6 (f32 sums in
another order).  JAX's slots and ownership are restated from
``nerf_fusion_tpu/ops/imgproc.py:319-329`` (int32 arithmetic: the Knuth
product wraps) and the port's recomputed by its own rule: the int32
product wrapped explicitly, low ``table_bits`` bits.
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
from nerf_fusion_tpu_torch.system.tracker import TrackerConfig
from nerf_fusion_tpu_torch.utils.config import dict_to_args

TBL = 1 << 20


def _cloud(name):
    if name == "uniform":           # test_box_filter.py: the per-cell oracle
        rng = np.random.default_rng(0)
        n = 20000
        pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        return pts, nrm, col, rng.uniform(size=n) > 0.1, 32768
    if name == "sparse":            # collision free, two points in one cell
        pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0],
                        [0.001, 0.001, 0.0], [2.0, 2.0, 2.0]], np.float32)
        nrm = np.tile(np.array([[0, 0, 1.0]], np.float32), (5, 1))
        return pts, nrm, None, np.ones(5, bool), 16
    rng = np.random.default_rng(1)  # more cells than capacity, out-of-extent points
    pts = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    pts[:64] *= 5.0
    nrm = np.tile(np.array([[0, 0, 1.0]], np.float32), (4096, 1))
    return pts, nrm, None, np.ones(4096, bool), 256


def _jax_slots(pts, valid, voxel_size=0.02, extent=8.0):
    grid = jnp.floor((jnp.asarray(pts) + extent) / voxel_size).astype(jnp.int32)
    n_cells = int(2 * extent / voxel_size)
    inb = jnp.all((grid >= 0) & (grid < n_cells), axis=-1) & jnp.asarray(valid)
    gid = (grid[:, 0] * n_cells + grid[:, 1]) * n_cells + grid[:, 2]
    h = jnp.where(inb, (gid * jnp.int32(-1640531535)) & (TBL - 1), TBL)
    winner = jnp.full((TBL + 1,), jnp.iinfo(jnp.int32).min, jnp.int32).at[h].max(gid)
    mine = inb & (winner[jnp.clip(h, 0, TBL - 1)] == gid) & (h < TBL)
    return np.asarray(h), np.asarray(winner[:TBL]), np.asarray(mine)


def _port_slots(pts, valid, voxel_size=0.02, extent=8.0):
    p = torch.as_tensor(pts)
    n_cells = int(2 * extent / voxel_size)
    grid = torch.floor((p + extent) / voxel_size).long()
    inb = torch.all((grid >= 0) & (grid < n_cells), dim=-1) & torch.as_tensor(valid)
    gid = imgproc._wrap_int32((grid[:, 0] * n_cells + grid[:, 1]) * n_cells + grid[:, 2])
    h = torch.where(inb, imgproc._wrap_int32(gid * imgproc._MIX) & (TBL - 1), TBL)
    winner = torch.full((TBL + 1,), torch.iinfo(torch.int32).min, dtype=torch.int64)
    winner.scatter_reduce_(0, h, gid, reduce="amax")
    mine = inb & (winner[h.clamp_max(TBL - 1)] == gid) & (h < TBL)
    return h.numpy(), winner[:TBL].numpy(), mine.numpy()


@pytest.mark.parametrize("name", ["uniform", "sparse", "truncated"])
def test_hash_box_filter_matches_jax(name):
    pts, nrm, col, valid, cap = _cloud(name)
    jh, jwin, jmine = _jax_slots(pts, valid)
    th, twin, tmine = _port_slots(pts, valid)
    assert np.array_equal(th, jh) and np.array_equal(twin, jwin)
    assert np.array_equal(tmine, jmine)
    kw = dict(voxel_size=0.02, capacity=cap)
    want = jimg.box_filter_points(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid),
                                  colors=None if col is None else jnp.asarray(col), **kw)
    got = imgproc.box_filter_points(torch.as_tensor(pts), torch.as_tensor(nrm),
                                    torch.as_tensor(valid),
                                    colors=None if col is None else torch.as_tensor(col), **kw)
    *wf, wmask, wdrop = (np.asarray(a) for a in want)
    *gf, gmask, gdrop = (a.numpy() for a in got)
    assert np.array_equal(gmask, wmask) and float(gdrop) == float(wdrop)
    assert gmask.sum() > 0
    for a, b in zip(gf, wf):            # points, normals[, colors], row by row
        assert np.abs(a[gmask] - b[wmask]).max() <= 1e-6
    if name == "uniform":
        assert 0.0 < float(gdrop) < 0.2      # collisions happen at 2^20 slots
    if name == "truncated":
        assert gmask.all()


def test_preprocess_frame_hash_filter_matches_jax():
    """A rendered 160x120 frame through both frontends with the hash filter:
    the same mask, cell order and drop; points and colors within 1e-6."""
    f = SyntheticSequence(n_frames=2, width=160, height=120).render_frame(0)
    c = f.calib
    rgb, depth = np.asarray(f.rgb, np.float32), np.asarray(f.depth, np.float32)
    kw = dict(depth_cut_min=0.5, depth_cut_max=5.0, point_budget=8192, subsample=0.5,
              outlier_radius=0.3, outlier_min_nb=6, normal_radius=0.4)
    pj = jax_preprocess(jnp.asarray(rgb), jnp.asarray(depth), c.fx, c.fy, c.cx, c.cy,
                        box_filter_exact=False, **kw)
    pt = preprocess_frame(torch.tensor(rgb), torch.tensor(depth), c.fx, c.fy, c.cx, c.cy,
                          box_filter_exact=False, **kw)
    m = np.asarray(pj.mask)
    assert m.sum() > 200 and np.array_equal(pt.mask.numpy(), m)
    assert float(pt.drop_frac) == float(pj.drop_frac)
    assert np.abs(pt.points.numpy()[m] - np.asarray(pj.points)[m]).max() <= 1e-6
    assert np.abs(pt.colors.numpy()[m] - np.asarray(pj.colors)[m]).max() <= 1e-6
    dots = np.sum(np.asarray(pj.normals)[m] * pt.normals.numpy()[m], -1)
    assert np.mean(dots > 0.999) > 0.99


def test_tracker_config_reads_box_filter_exact():
    base = {"iter_config": [{"n": 1, "type": [["sdf"]]}], "sdf": {}, "rgb": {"weight": 1.0}}
    assert TrackerConfig.from_args(dict_to_args(base)).box_filter_exact is True
    hashed = dict(base, preprocess={"box_filter_exact": False})
    assert TrackerConfig.from_args(dict_to_args(hashed)).box_filter_exact is False
