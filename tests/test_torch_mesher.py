"""Port's marching cubes and mesher against the JAX package.

Both packages mesh the same map state (a 160x120 keyframe integrated by
the JAX package, copied into the port).  Same triangle count, same order,
vertices within 1e-5 m: the decoder samples differ by f32 rounding only
(~1e-6), which moves a vertex by ~1e-7 of a voxel.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops.marching_cubes import marching_cubes_sparse as jax_mc
from nerf_fusion_tpu.system import map as jmap
from nerf_fusion_tpu.system import mesher as jmesher
from nerf_fusion_tpu.system.frontend import preprocess_frame as jax_preprocess
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops.marching_cubes import marching_cubes_sparse
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system import mesher as tmesher
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[-3.0, -1.0, -3.0], bound_max=[3.0, 3.0, 3.0],
                voxel_size=0.1, prune_min_vox_obs=4, ignore_count_th=4.0,
                encoder_count_th=600.0, latent_capacity=4096, alloc_capacity=2048)
VERT_TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def maps():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    margs = dict_to_args(MAP_ARGS)
    jv = jmap.SparseVoxelMap(jm, margs, 29)
    tv = tmap.SparseVoxelMap(tm, margs, 29, "cpu")
    seq = SyntheticSequence(n_frames=3, width=160, height=120)
    for i in (0, 2):
        f = seq.render_frame(i)
        c = f.calib
        pre = jax_preprocess(jnp.asarray(f.rgb), jnp.asarray(f.depth), c.fx, c.fy, c.cx,
                             c.cy, 0.5, 5.0, 4096, outlier_radius=0.3, outlier_min_nb=6,
                             normal_radius=0.4)
        jv.integrate_keyframe(pre.points, pre.normals, valid=pre.mask, pose=f.gt_pose)
    tv.state = tmap.MapState(*(_t(a) for a in jv.state))
    tv._updated_dev = _t(jv._updated_dev)
    return jv, tv


def _same_triangles(jres, tres, n):
    assert int(tres.n_triangles) == int(jres.n_triangles) == n
    assert np.abs(tres.vertices[:n].numpy() - np.asarray(jres.vertices)[:n]).max() <= VERT_TOL
    assert np.abs(tres.vertex_std[:n].numpy()
                  - np.asarray(jres.vertex_std)[:n]).max() <= 1e-4
    assert np.array_equal(tres.flatten_id[:n].numpy(), np.asarray(jres.flatten_id)[:n])
    assert bool(tres.cells_dropped) == bool(jres.cells_dropped)


@pytest.mark.parametrize("mesh_budget", [4096, 512])
def test_fused_extract_matches_jax(maps, mesh_budget):
    """4096 takes every updated voxel; 512 truncates the batch and defers
    the rest (the leftover mask must agree too)."""
    jv, tv = maps
    upd = np.asarray(jv._updated_dev)
    jres, jids, jkeep, _, jleft, jn_left, _ = jmesher.fused_extract(
        jv.state, jnp.asarray(upd), jv.cfg, jv.model.decoder_params,
        jv.model.decoder_config, 4, False, mesh_budget, 32768, 1024, 0.15)
    tres, tids, tkeep, _, tleft, tn_left = tmesher.fused_extract(
        tv.state, _t(upd), tv.cfg, tv.model.decoder, 4, mesh_budget, 32768, 0.15)
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tleft.numpy(), np.asarray(jleft))
    assert int(tn_left) == int(jn_left)
    if mesh_budget == 512:
        assert int(tn_left) > 0
    n = int(jres.n_triangles)
    assert n > 500
    _same_triangles(jres, tres, n)


def test_mesher_extract_and_drain_matches_jax(maps, tmp_path):
    """The materialising extraction with a small batch budget drains the
    deferred voxels over several rounds; both caches end identical."""
    jv, tv = maps
    jme = jmesher.Mesher(jv, max_n_triangles=131072, mesh_batch_budget=512)
    tme = tmesher.Mesher(tv, max_n_triangles=131072, mesh_batch_budget=512)
    jmesh = jme.extract(4, max_std=0.15)
    tmesh = tme.extract(4, max_std=0.15)
    assert tmesh.shape == jmesh.shape and len(tmesh) > 500
    assert np.abs(tmesh - jmesh).max() <= VERT_TOL
    assert np.array_equal(tme.vertices_flatten_id, jme.vertices_flatten_id)
    tme.save_ply(tmp_path / "t.ply")
    jme.save_ply(tmp_path / "j.ply")
    th = (tmp_path / "t.ply").read_bytes().split(b"end_header")[0]
    jh = (tmp_path / "j.ply").read_bytes().split(b"end_header")[0]
    assert th == jh


def test_full_remesh_matches_jax(maps):
    """The unbounded chunked re-mesh (``no_cache``; also the repair path
    after a batch lost triangles to a device budget)."""
    jv, tv = maps
    jmesh = jmesher.Mesher(jv, max_n_triangles=131072).extract(4, max_std=0.15,
                                                               no_cache=True)
    tme = tmesher.Mesher(tv, max_n_triangles=131072)
    tmesh = tme.extract(4, max_std=0.15, no_cache=True)
    assert tmesh.shape == jmesh.shape and len(tmesh) > 500
    assert np.abs(tmesh - jmesh).max() <= VERT_TOL
    # a batch whose triangles overflow the fused budget schedules the repair
    tme2 = tmesher.Mesher(tv, max_n_triangles=131072)
    tme2.fused_tri_budget = 64
    tv.updated_slots[:] = True
    tme2.extract(4, max_std=0.15)
    assert tme2.vertices.shape == tmesh.shape
    assert np.abs(tme2.vertices - tmesh).max() <= VERT_TOL


def test_marching_cubes_sphere_field_matches_jax():
    """A sphere SDF sampled on every voxel's margin lattice, one batch."""
    r = 4
    n_xyz = (6, 6, 6)
    ids = np.arange(216)
    xyz = np.stack([ids // 36, (ids // 6) % 6, ids % 6], 1)
    offs = tmesher._sample_offsets(r) + 0.5
    p = (xyz[:, None, :] + offs[None]) * 0.1                          # world, origin 0
    sdf = (np.linalg.norm(p - 0.3, axis=-1) - 0.2).astype(np.float32)
    std = (0.05 + 0.01 * np.abs(np.sin(7 * p[..., 0]))).astype(np.float32)
    cube_sdf = sdf.reshape(216, 2 * r, 2 * r, 2 * r)
    cube_std = std.reshape(216, 2 * r, 2 * r, 2 * r)
    indexer = np.arange(216, dtype=np.int32)
    batch_map = np.arange(216, dtype=np.int32)
    valid = np.ones(216, bool)
    valid[5] = False
    jres = jax_mc(jnp.asarray(indexer), jnp.asarray(batch_map), jnp.asarray(ids, jnp.int32),
                  jnp.asarray(valid), jnp.asarray(cube_sdf), jnp.asarray(cube_std),
                  n_xyz, 0.1, jnp.zeros(3), r, 216, 0.15, 8192)
    tres = marching_cubes_sparse(_t(indexer), _t(batch_map), _t(ids), _t(valid),
                                 _t(cube_sdf), _t(cube_std), n_xyz, 0.1, (0.0, 0.0, 0.0),
                                 r, 216, 0.15, 8192)
    n = int(jres.n_triangles)
    assert n > 100
    _same_triangles(jres, tres, n)
