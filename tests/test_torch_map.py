"""Port's map integration and persistence against the JAX package.

One preprocessed keyframe (160x120 synthetic frame, its ground-truth
pose) is integrated by both packages with identical ``ckpt/default``
weights: the indexer, positions and ``n_occupied`` must agree exactly,
obs counts exactly (integer pair counts), latents to 1e-4 (f32 encoder
and running-mean sums in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops import voxel as jvox
from nerf_fusion_tpu.system import map as jmap
from nerf_fusion_tpu.system.frontend import preprocess_frame as jax_preprocess
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import voxel as vox
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[-3.0, -1.0, -3.0], bound_max=[3.0, 3.0, 3.0],
                voxel_size=0.1, prune_min_vox_obs=4, ignore_count_th=4.0,
                encoder_count_th=600.0, latent_capacity=4096, alloc_capacity=2048)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def integrated():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    seq = SyntheticSequence(n_frames=2, width=160, height=120)
    f = seq.render_frame(0)
    c = f.calib
    pre = jax_preprocess(jnp.asarray(f.rgb), jnp.asarray(f.depth), c.fx, c.fy, c.cx,
                         c.cy, 0.5, 5.0, 4096, outlier_radius=0.3, outlier_min_nb=6,
                         normal_radius=0.4)
    R = np.asarray(f.gt_pose.q.rotation_matrix, np.float32)
    t = np.asarray(f.gt_pose.t, np.float32)
    margs = dict_to_args(MAP_ARGS)
    jcfg = jmap.MapConfig.from_args(margs, 29)
    tcfg = tmap.MapConfig.from_args(margs, 29)
    js, jupd, _ = jmap.integrate_keyframe(
        jmap.init_state(jcfg), jcfg, jm.encoder_params, jm.encoder_bn,
        jm.encoder_config, pre.points, pre.normals, pre.mask,
        jnp.asarray(R), jnp.asarray(t))
    ts, tupd = tmap.integrate_keyframe(
        tmap.init_state(tcfg, "cpu"), tcfg, tm.encoder, _t(pre.points),
        _t(pre.normals), _t(pre.mask), _t(R), _t(t))
    return js, jupd, ts, tupd, tcfg, tm


def test_integrate_matches_jax(integrated):
    js, jupd, ts, tupd, _, _ = integrated
    assert int(ts.n_occupied) == int(js.n_occupied) > 100
    assert np.array_equal(ts.indexer.numpy(), np.asarray(js.indexer))
    assert np.array_equal(ts.positions.numpy(), np.asarray(js.positions))
    assert np.array_equal(tupd.numpy(), np.asarray(jupd))
    assert np.array_equal(ts.obs_count.numpy(), np.asarray(js.obs_count))
    assert np.abs(ts.latents.numpy() - np.asarray(js.latents)).max() <= 1e-4
    assert bool(ts.overflow) == bool(js.overflow) is False
    assert ts.indexer.dtype == torch.int32 and ts.positions.dtype == torch.int32


def test_map_npz_roundtrip_and_layout(integrated, tmp_path):
    js, _, ts, _, _, tm = integrated
    margs = dict_to_args(MAP_ARGS)
    m = tmap.SparseVoxelMap(tm, margs, 29, "cpu")
    m.state = ts
    m.save(tmp_path / "map.npz")
    with np.load(tmp_path / "map.npz") as d:
        for k, v in js._asdict().items():
            assert d[k].dtype == np.asarray(v).dtype and d[k].shape == np.asarray(v).shape
    m2 = tmap.SparseVoxelMap(tm, margs, 29, "cpu")
    m2.load(tmp_path / "map")
    for a, b in zip(m2.state, ts):
        assert torch.equal(a, b)


def test_get_sdf_on_integrated_map(integrated):
    js, _, ts, _, tcfg, tm = integrated
    jm, _ = jax_load_model(CKPT, 300)
    jcfg = jmap.MapConfig.from_args(dict_to_args(MAP_ARGS), 29)
    occ = ts.positions.numpy()[: int(ts.n_occupied)].astype(np.int64)
    xyz = np.stack([occ // (40 * 60), (occ // 60) % 40, occ % 60], 1)
    rng = np.random.RandomState(0)
    pts = ((xyz + rng.rand(*xyz.shape)) * 0.1 + np.array([-3.0, -1.0, -3.0])).astype(np.float32)
    sj, dj, vj = jmap.get_sdf(js, jcfg, jm.decoder_params, jm.decoder_config, jnp.asarray(pts))
    st, dt, vt = tmap.get_sdf(ts, tcfg, tm.decoder, _t(pts))
    assert np.array_equal(vt.numpy(), np.asarray(vj)) and vt.any()
    assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-3
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-3


def test_voxel_ops_match_jax():
    rng = np.random.RandomState(3)
    n_xyz = (7, 5, 9)
    ids = rng.randint(0, 7 * 5 * 9, 500).astype(np.int32)
    valid = rng.rand(500) > 0.3
    ti, tv = torch.as_tensor(ids.astype(np.int64)), torch.as_tensor(valid)
    assert np.array_equal(vox.occurrence_count(ti, tv).numpy(),
                          np.asarray(jvox.occurrence_count(jnp.asarray(ids), jnp.asarray(valid))))
    for cap in (64, 1000):
        ju = jvox.masked_unique(jnp.asarray(ids), jnp.asarray(valid), cap)
        tu = vox.masked_unique(ti, tv, cap)
        for a, b in zip(ju, tu):
            assert np.array_equal(np.asarray(a), b.numpy())
        jc = jvox.compact_by_mask(jnp.asarray(ids), jnp.asarray(valid), cap)
        tc = vox.compact_by_mask(ti, tv, cap)
        for a, b in zip(jc, tc):
            assert np.array_equal(np.asarray(a), b.numpy())
    je = jvox.expand_neighbors6(jnp.asarray(ids), jnp.asarray(valid), n_xyz)
    te = vox.expand_neighbors6(ti, tv, n_xyz)
    for a, b in zip(je, te):
        assert np.array_equal(np.asarray(a), b.numpy())
    xyz = np.asarray(jvox.unlinearize_id(jnp.asarray(ids), n_xyz))
    assert np.array_equal(vox.unlinearize_id(ti, n_xyz).numpy(), xyz)
    assert np.array_equal(vox.linearize_id(torch.as_tensor(xyz.astype(np.int64)), n_xyz).numpy(),
                          ids)
    vals = rng.randn(500, 4).astype(np.float32)
    js = jvox.masked_segment_sum(jnp.asarray(vals), jnp.asarray(ids % 50),
                                 jnp.asarray(valid), 50)
    ts = vox.masked_segment_sum(_t(vals), torch.as_tensor(ids % 50).long(), tv, 50)
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-5
    pts = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    bmin = np.array([-1.0, -1.0, -1.0], np.float32)
    jn, jg = jvox.world_to_grid(jnp.asarray(pts), jnp.asarray(bmin), 0.25)
    tn, tg = vox.world_to_grid(_t(pts), _t(bmin), 0.25)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(vox.in_bounds(tg, (8, 8, 8)).numpy(),
                          np.asarray(jvox.in_bounds(jg, (8, 8, 8))))
