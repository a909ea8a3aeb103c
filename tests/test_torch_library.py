"""Library functions of the port that no fusion path calls, against the JAX
package: ``bilateral_depth_filter``, ``sensor_noise_weight``,
``radius_outlier_mask_exact``, ``masked_segment_max``,
``dense_marching_cubes``, and the sparse marching cubes'
``frontier_kill`` on the three cases of ``tests/test_frontier.py``.

Tolerances: the depth filter within 1e-5 (f32 exponentials in another
order) with NaN at the same pixels, border wrap included; the noise weight
within 1e-6; masks, segment maxima and triangle counts exact; dense
triangles within 1e-6 (float64 on both sides); sparse triangles within
1e-5 (f32 corner blends in another order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops import imgproc as JI
from nerf_fusion_tpu.ops import marching_cubes as JMC
from nerf_fusion_tpu.ops import voxel as JV
from nerf_fusion_tpu.system.map import SparseVoxelMap as JaxMap
from nerf_fusion_tpu.system.mesher import Mesher as JaxMesher
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import imgproc as TI
from nerf_fusion_tpu_torch.ops import marching_cubes as TMC
from nerf_fusion_tpu_torch.ops import voxel as TV
from nerf_fusion_tpu_torch.system.map import SparseVoxelMap
from nerf_fusion_tpu_torch.system.mesher import Mesher
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test processes run side by side (pytest-xdist)
    and the small shapes here gain nothing from a thread pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_nan(a, b):
    return np.array_equal(np.isnan(a), np.isnan(b))


def test_bilateral_depth_filter_matches_jax():
    rng = np.random.RandomState(0)
    depth = np.full((32, 40), 2.0, np.float32)
    depth[:, 20:] = 3.0                               # a depth edge
    depth += rng.randn(32, 40).astype(np.float32) * 0.01
    depth[5, 5] = depth[0, 0] = depth[31, 39] = np.nan
    depth[0, 10:14] = 0.3                             # near the border: the wrap counts
    for kw in ({}, {"radius": 1, "sigma_space": 1.0, "sigma_depth_factor": 0.1}):
        ref = np.asarray(JI.bilateral_depth_filter(jnp.asarray(depth), **kw))
        got = TI.bilateral_depth_filter(torch.from_numpy(depth), **kw).numpy()
        assert _same_nan(got, ref) and np.isnan(got[5, 5])
        ok = ~np.isnan(ref)
        assert np.abs(got[ok] - ref[ok]).max() <= 1e-5
    # the border wraps: row 0 sees row 31 (torch.roll, as jnp.roll)
    d = np.full((8, 8), 1.0, np.float32)
    d[-1] = 1.02
    got = TI.bilateral_depth_filter(torch.from_numpy(d)).numpy()
    assert got[0, 4] > 1.0 + 1e-4


def test_sensor_noise_weight_matches_jax():
    rng = np.random.RandomState(1)
    H, W = 24, 32
    depth = rng.uniform(0.3, 4.0, (H, W)).astype(np.float32)
    n = rng.randn(3, H, W).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    valid = rng.rand(H, W) > 0.2
    ref = np.asarray(JI.sensor_noise_weight(jnp.asarray(depth), jnp.asarray(n),
                                            jnp.asarray(valid)))
    got = TI.sensor_noise_weight(torch.from_numpy(depth), torch.from_numpy(n),
                                 torch.from_numpy(valid)).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    assert (got[~valid] == 0).all() and (got[valid] > 0).all() and got.max() <= 1.0


def test_radius_outlier_exact_matches_jax_and_windowed():
    """The exact mask equals JAX's; the windowed count agrees with it on more
    than 90 % of the valid pixels (``tests/test_parity_extras.py``)."""
    fr = SyntheticSequence(n_frames=1, width=160, height=120).render_frame(0)
    c = fr.calib
    depth = torch.from_numpy(np.array(fr.depth, np.float32))
    pts = TI.unproject_depth(depth, c.fx, c.fy, c.cx, c.cy)
    valid = torch.isfinite(depth)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts))
    approx = (valid & (TI.radius_neighbor_count(pts0, valid, radius=0.05) >= 16)).numpy()
    vm = valid.numpy().reshape(-1)
    flat = pts0.numpy().reshape(3, -1).T[vm]
    exact = TI.radius_outlier_mask_exact(flat, 16, 0.05)
    assert np.array_equal(exact, JI.radius_outlier_mask_exact(flat, 16, 0.05))
    assert 0 < exact.sum() < len(exact)
    assert (approx.reshape(-1)[vm] == exact).mean() > 0.9


@pytest.mark.parametrize("dtype,fill", [(np.float32, None), (np.float32, 0.0),
                                        (np.int32, None), (np.int32, -7)])
def test_masked_segment_max_matches_jax(dtype, fill):
    """Empty buckets included: JAX's identity (-inf, the lowest int) or
    ``fill_value``; 1-D and 2-D values."""
    rng = np.random.RandomState(2)
    for shape in ((100, 4), (100,)):
        vals = (rng.randn(*shape) * 10).astype(dtype)
        seg = rng.randint(0, 14, 100)
        seg[seg == 3] = 4                               # bucket 3 is empty
        valid = rng.rand(100) > 0.3
        valid[seg == 5] = False                         # bucket 5 has rows, none valid
        ref = np.asarray(JV.masked_segment_max(jnp.asarray(vals), jnp.asarray(seg),
                                               jnp.asarray(valid), 14, fill_value=fill))
        got = TV.masked_segment_max(torch.from_numpy(vals), torch.from_numpy(seg),
                                    torch.from_numpy(valid), 14, fill_value=fill).numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _edges(tris, decimals=6):
    directed = {}
    for tri in tris.round(decimals):
        for i in range(3):
            a, b = tuple(tri[i]), tuple(tri[(i + 1) % 3])
            directed[(a, b)] = directed.get((a, b), 0) + 1
    return directed


def test_dense_marching_cubes_matches_jax_and_is_watertight():
    n = 16
    g = np.linspace(-1.2, 1.2, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sphere = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.9
    kw = dict(origin=(-1.2, -1.2, -1.2), spacing=g[1] - g[0])
    tris = TMC.dense_marching_cubes(sphere, **kw)
    ref = JMC.dense_marching_cubes(sphere, **kw)
    assert tris.shape == ref.shape and len(tris) > 100
    assert np.abs(tris - ref).max() <= 1e-6
    directed = _edges(tris)
    for (a, b), cnt in directed.items():
        assert cnt == 1 and directed.get((b, a), 0) == 1      # watertight, consistent
    ctr = tris.mean(axis=1)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    assert (np.einsum("ij,ij->i", nrm, ctr) > 0).mean() > 0.999   # outward
    rng = np.random.RandomState(0)
    field = sum(rng.randn() * np.cos(k[0] * X + k[1] * Y + k[2] * Z)
                for k in rng.randn(4, 3) * 3)
    a, b = TMC.dense_marching_cubes(field), JMC.dense_marching_cubes(field)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6
    assert TMC.dense_marching_cubes(np.ones((4, 4, 4))).shape == (0, 3, 3)


def _mc_case(broken: bool):
    """``tests/test_frontier.py``'s inputs: a consistent batch (one voxel
    whose cube crosses the z mid-plane), or an inconsistent one whose first
    row's own voxel is missing from the indexer."""
    n_xyz, r, cap = (3, 3, 3), 2, 8
    k = np.arange(2 * r)
    plane = np.broadcast_to((k - r + 0.5) / r, (2 * r, 2 * r, 2 * r))
    indexer = np.full((27,), -1, np.int32)
    batch_map = np.full((cap,), -1, np.int32)
    batch_map[0] = 0
    pos_a = (1 * 3 + 1) * 3 + 1
    if broken:
        pos_b = (1 * 3 + 1) * 3 + 2
        indexer[pos_b] = 1
        batch_map[1] = 1
        positions = [pos_a, pos_b]
        cube_sdf = np.stack([plane, np.full_like(plane, -0.2)]).astype(np.float32)
    else:
        indexer[pos_a] = 0
        positions = [pos_a]
        cube_sdf = plane[None].astype(np.float32)
    arrays = dict(indexer=indexer, batch_map=batch_map,
                  positions_b=np.asarray(positions, np.int32),
                  batch_valid=np.ones(len(positions), bool), cube_sdf=cube_sdf,
                  cube_std=np.full_like(cube_sdf, 0.05))
    static = dict(n_xyz=n_xyz, voxel_size=0.1, r=r, latent_capacity=cap, max_std=10.0,
                  budget=256)
    return arrays, static, pos_a


def _sparse_both(arrays, static, kill):
    jres = JMC.marching_cubes_sparse(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                     bound_min=jnp.zeros(3, jnp.float32), frontier_kill=kill,
                                     **static)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    t["indexer"], t["batch_map"] = t["indexer"].long(), t["batch_map"].long()
    t["positions_b"] = t["positions_b"].long()
    tres = TMC.marching_cubes_sparse(
        t["indexer"], t["batch_map"], t["positions_b"], t["batch_valid"], t["cube_sdf"],
        t["cube_std"], static["n_xyz"], static["voxel_size"], (0.0, 0.0, 0.0), static["r"],
        static["latent_capacity"], static["max_std"], static["budget"], frontier_kill=kill)
    n = int(jres.n_triangles)
    assert int(tres.n_triangles) == n
    assert np.abs(tres.vertices[:n].numpy() - np.asarray(jres.vertices[:n])).max(
        initial=0.0) <= 1e-5
    fid = tres.flatten_id[:n].numpy()
    assert np.array_equal(fid, np.asarray(jres.flatten_id[:n]))
    return n, fid


@pytest.mark.parametrize("kill", [True, False])
def test_frontier_kill_matches_jax_on_a_consistent_batch(kill):
    arrays, static, _ = _mc_case(broken=False)
    n, _ = _sparse_both(arrays, static, kill)
    assert n > 0 and n == _sparse_both(arrays, static, not kill)[0]


def test_frontier_kill_matches_jax_on_an_inconsistent_batch():
    arrays, static, pos_a = _mc_case(broken=True)
    n_soft, fid_soft = _sparse_both(arrays, static, kill=False)
    assert n_soft > 0 and (fid_soft == pos_a).any()       # meshed from the neighbour's margin
    _, fid_kill = _sparse_both(arrays, static, kill=True)
    assert not (fid_kill == pos_a).any()                   # the kill suppresses the row


def test_half_observed_sphere_no_frontier_extrusion():
    """Only the x <= 0.5 hemisphere is observed; both packages' meshers give
    the same number of triangles, none beyond the allocated margin."""
    args = dict_to_args(dict(
        bound_min=[0.0, 0.0, 0.0], bound_max=[1.0, 1.0, 1.0], voxel_size=0.1,
        prune_min_vox_obs=4, ignore_count_th=16.0, encoder_count_th=600.0,
        latent_capacity=2048, alloc_capacity=512))
    rng = np.random.RandomState(1)
    v = rng.randn(4000, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 0] = -np.abs(v[:, 0])
    pts = (np.array([0.5, 0.5, 0.5]) + 0.25 * v).astype(np.float32)
    nrm = v.astype(np.float32)
    jm, _ = jax_load_model(CKPT, 300)
    jmap = JaxMap(jm, args, latent_dim=29)
    jmap.integrate_keyframe(pts, nrm)
    ref = JaxMesher(jmap, max_n_triangles=1 << 15).extract(voxel_resolution=4, max_std=0.3,
                                                          fast=False)
    tm, _ = load_model(CKPT, 300)
    tmap = SparseVoxelMap(tm, args, 29, "cpu")
    tmap.integrate_keyframe(pts, nrm)
    tris = Mesher(tmap, max_n_triangles=1 << 15).extract(voxel_resolution=4, max_std=0.3,
                                                         fast=False)
    assert len(tris) == len(ref) > 50
    verts = tris.reshape(-1, 3)
    assert verts[:, 0].max() <= 0.5 + 2 * 0.1 + 1e-6
    west = verts[verts[:, 0] < 0.45]
    err = np.abs(np.linalg.norm(west - 0.5, axis=1) - 0.25)
    assert len(west) > 30 and np.median(err) < 0.05
