"""The port's LIF data path against the JAX package: mesh utilities, the
sign-vote sampler, the providers, the generator (bitwise), ``LifDataset``
(bitwise for one seed) and ``DeviceLifDataset`` (by its distributions, on
CPU tensors)."""

import json

import numpy as np
import pytest
import torch

import nerf_fusion_tpu.data.generator as jgen
from nerf_fusion_tpu.data.lif_dataset import LifDataset as JLifDataset
from nerf_fusion_tpu.data.lif_dataset import batch_iterator as jbatch_iterator
from nerf_fusion_tpu.data.providers import ShapeNetGenerator as JShapeNetGenerator
from nerf_fusion_tpu.data.providers import SimpleShapeGenerator as JSimpleShapeGenerator
from nerf_fusion_tpu.ops import mesh as jmesh
from nerf_fusion_tpu.ops import sdf_sampler as jsampler
from nerf_fusion_tpu.utils.config import dict_to_args as jdict_to_args
from nerf_fusion_tpu_torch.data import generator as tgen
from nerf_fusion_tpu_torch.data.device_lif import DeviceLifDataset
from nerf_fusion_tpu_torch.data.lif_dataset import (LifCombinedDataset, LifDataset,
                                                    batch_iterator, perturb_normal)
from nerf_fusion_tpu_torch.data.providers import ShapeNetGenerator, SimpleShapeGenerator
from nerf_fusion_tpu_torch.native import knn_sign_vote
from nerf_fusion_tpu_torch.ops import mesh
from nerf_fusion_tpu_torch.ops import sdf_sampler
from nerf_fusion_tpu_torch.utils.config import dict_to_args

GEN_ARGS = dict(provider="simple_shape", provider_kwargs={"n_shapes": 2}, sample_method=2,
                sampler_var=0.005, sampler_count=60000, voxel_size=0.08, nn_size=2.0, nproc=0)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.name != "config.json"}


def _run_jax_generator(args):
    # the JAX generator counts meshes in module globals that persist across
    # runs in one process: start them at zero as a fresh process would
    jgen._counter.value = 0
    jgen._bad_counter.value = 0
    return jgen.run_generator(args)


@pytest.fixture(scope="module")
def lif_dirs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lifdata")
    jdir = _run_jax_generator(jdict_to_args(dict(GEN_ARGS, output=str(out / "jax"))))
    tdir = tgen.run_generator(dict_to_args(dict(GEN_ARGS, output=str(out / "port"))))
    return jdir, tdir


def test_generator_bitwise_the_jax_generator(lif_dirs):
    jdir, tdir = lif_dirs
    jf, tf = _files(jdir), _files(tdir)
    assert len(tf) > 100 and sorted(tf) == sorted(jf)
    assert [k for k in jf if jf[k] != tf[k]] == []
    jcfg = json.loads((jdir / "config.json").read_text())
    tcfg = json.loads((tdir / "config.json").read_text())
    assert {k: v for k, v in tcfg.items() if k != "output"} == \
        {k: v for k, v in jcfg.items() if k != "output"}


def test_generator_with_workers_matches_one_process(lif_dirs, tmp_path):
    _, tdir = lif_dirs
    out = tgen.run_generator(dict_to_args(dict(GEN_ARGS, nproc=2, output=str(tmp_path / "w2"))))
    assert _files(out) == _files(tdir)


def test_shapenet_provider_and_generator(tmp_path):
    """ShapeNetGenerator on an OBJ directory in the ShapeNetCore.v2 layout:
    items as the JAX provider's, and the generator's output bitwise."""
    for cat, shape, dims in [("02871439", "aaaa", (0.4, 0.6, 0.5)),
                             ("03001627", "bbbb", (0.5, 0.3, 0.7)),
                             ("03001627", "cccc", (0.2, 0.6, 0.3))]:
        mdir = tmp_path / "sn" / cat / shape / "models"
        mdir.mkdir(parents=True)
        V, F = jmesh.box_mesh(*dims)
        jmesh.save_obj(mdir / "model_normalized.obj", V - V.mean(0), F)
    kw = dict(shapenet_path=str(tmp_path / "sn"), categories=["02871439", "03001627", "99999999"],
              shapes_per_category=[5, 1, 5], scale=[1.0, 1.7, 1.0])
    port, ref = ShapeNetGenerator(**kw), JShapeNetGenerator(**kw)
    assert len(port) == len(ref) == 2
    for i in range(2):
        assert port.get_source(i) == ref.get_source(i)
        a, b = port[i], ref[i]
        assert np.array_equal(a["vertices"], b["vertices"]) and np.array_equal(a["faces"], b["faces"])
        assert a["sampler_mult"] == b["sampler_mult"]
    args = dict(provider="shapenet_model", provider_kwargs=kw, sample_method=2,
                sampler_var=0.005, sampler_count=8000, voxel_size=0.08, nn_size=2.0, nproc=0)
    jdir = _run_jax_generator(jdict_to_args(dict(args, output=str(tmp_path / "jax"))))
    tdir = tgen.run_generator(dict_to_args(dict(args, output=str(tmp_path / "port"))))
    jf, tf = _files(jdir), _files(tdir)
    assert len(tf) > 2 and jf == tf


def test_simple_shape_items_and_cameras():
    port, ref = SimpleShapeGenerator(3, seed=7), JSimpleShapeGenerator(3, seed=7)
    for i in range(3):
        a, b = port[i], ref[i]
        assert port.get_source(i) == ref.get_source(i)
        assert np.array_equal(a["vertices"], b["vertices"]) and np.array_equal(a["faces"], b["faces"])
        assert a["ortho_half"] == b["ortho_half"] and len(a["cameras"]) == 100
        assert all(np.array_equal(ca.matrix, cb.matrix)
                   for ca, cb in zip(a["cameras"], b["cameras"]))


def test_native_sign_vote_matches_scipy_and_jax():
    rng = np.random.RandomState(1)
    d = rng.randn(5000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    surf, nrm = 0.5 * d, d
    q = rng.randn(20000, 3) * 0.4
    sdf_n, keep_n = knn_sign_vote(q, surf, nrm, 11)
    sdf_s, keep_s = sdf_sampler.sign_vote_sdf_plain(q, surf, nrm, 11)
    assert (keep_n == keep_s).all()
    np.testing.assert_allclose(sdf_n[keep_n], sdf_s[keep_s], rtol=0, atol=1e-12)
    # the JAX package's sampler (its native library, or its scipy fallback)
    sdf_j, keep_j = jsampler.sign_vote_sdf(q, surf, nrm, 11)
    assert (keep_j == keep_n).all()
    np.testing.assert_allclose(sdf_n[keep_n], sdf_j[keep_j], rtol=0, atol=1e-12)
    sdf_p, keep_p = sdf_sampler.sign_vote_sdf(q, surf, nrm, 11)
    assert np.array_equal(sdf_p, sdf_n) and np.array_equal(keep_p, keep_n)


@pytest.mark.parametrize("method", [1, 2])
def test_sample_mesh_sdf_matches_jax(method):
    item = SimpleShapeGenerator(1, seed=4)[0]
    kw = dict(n_samples=6000, var=0.005, expand=0.2, method=method,
              cameras=item["cameras"][:20], ortho_half=item["ortho_half"])
    d_t, s_t = sdf_sampler.sample_mesh_sdf(item["vertices"], item["faces"],
                                           rng=np.random.RandomState(3), **kw)
    d_j, s_j = jsampler.sample_mesh_sdf(item["vertices"], item["faces"],
                                        rng=np.random.RandomState(3), **kw)
    assert np.array_equal(s_t, s_j) and np.array_equal(d_t, d_j)
    # the sign vote gives the sphere-like primitives' inside negative
    assert (d_t[:, 3] < 0).any() and (d_t[:, 3] > 0).any()


def test_primitive_meshes_closed_and_obj_io(tmp_path):
    for V, F in [mesh.box_mesh(1, 0.5, 2), mesh.sphere_mesh(0.5, 12, 24),
                 mesh.cylinder_mesh(0.5, 1, 24)]:
        edges = {}
        for tri in F:
            for i in range(3):
                e = (int(tri[i]), int(tri[(i + 1) % 3]))
                edges[e] = edges.get(e, 0) + 1
        assert all(c == 1 and edges.get((b, a), 0) == 1 for (a, b), c in edges.items())
        n, area = mesh.face_normals(V, F)
        ctr = V[F].mean(axis=1)
        assert np.einsum("ij,ij->i", ctr - V.mean(0), n * area[:, None]).sum() > 0
    V, F = mesh.box_mesh(1.0, 2.0, 0.5)
    mesh.save_obj(tmp_path / "m.obj", V, F)
    jmesh.save_obj(tmp_path / "j.obj", V, F)
    assert (tmp_path / "m.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    (tmp_path / "quad.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    V2, F2 = mesh.load_obj(tmp_path / "quad.obj")
    assert len(V2) == 4 and F2.tolist() == [[0, 1, 2], [0, 2, 3]]
    pts, nrm = mesh.sample_surface(V, F, 500, np.random.RandomState(2))
    pj, nj = jmesh.sample_surface(V, F, 500, np.random.RandomState(2))
    assert np.array_equal(pts, pj) and np.array_equal(nrm, nj)


@pytest.mark.parametrize("aug", [None, "Y", "X", "Z", "3D"])
def test_lif_dataset_batches_bitwise_jax(lif_dirs, aug):
    jdir, tdir = lif_dirs
    kw = dict(num_sample=64, num_surface_sample=32, augment_rotation=aug,
              augment_noise=(0.025, 40.0) if aug else (0.0, 0.0), seed=3)
    port, ref = LifDataset(str(tdir), **kw), JLifDataset(str(jdir), **kw)
    idxs = np.array([5, 0, 17, 5, 200, 31, 2, 9])
    for _ in range(2):
        a, b = port.sample_batch(idxs), ref.sample_batch(idxs)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    if aug != "Y":      # Y's itemwise path draws its base angle from the global `random`
        for i in (0, 7):
            a, b = port[i], ref[i]
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_batch_iterator_bitwise_jax_and_max_batches(lif_dirs):
    jdir, tdir = lif_dirs
    kw = dict(num_sample=32, num_surface_sample=16, augment_rotation="Y",
              augment_noise=(0.025, 40.0), seed=1)
    port = LifCombinedDataset(LifDataset(str(tdir), **kw))
    ref = JLifDataset(str(jdir), **kw)
    a = list(batch_iterator(port, 64, seed=11))
    b = list(jbatch_iterator(ref, 64, seed=11))
    assert len(a) == len(b) == len(port) // 64
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))
    # an epoch cut at 3 batches draws nothing past them: the next epoch's
    # batches are those of a dataset that ran exactly 3 batches
    cut = LifDataset(str(tdir), **kw)
    for _ in batch_iterator(cut, 64, seed=11, max_batches=3):
        pass
    ran3 = LifDataset(str(tdir), **kw)
    for s in range(3):
        ran3.sample_batch(np.arange(s * 64, (s + 1) * 64))
    x, y = cut.sample_batch(np.arange(8)), ran3.sample_batch(np.arange(8))
    assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])


def test_packed_sampler_trailing_empty_pool(tmp_path):
    pdir = tmp_path / "payload"
    pdir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        data = rng.randn(50, 4).astype(np.float32)
        if i == 2:
            data[:, 3] = -np.abs(data[:, 3])
        np.savez(pdir / ("%08d.npz" % i), data=data, surface=rng.randn(20, 6).astype(np.float32),
                 min=np.zeros(3, np.float32), max=np.ones(3, np.float32))
    (tmp_path / "source.json").write_text(json.dumps([["t", 0, i] for i in range(3)]))
    ds = LifDataset(str(tmp_path), num_sample=16, num_surface_sample=8)
    sdf, _ = ds.sample_batch(np.array([0, 1, 2]))
    assert np.all(sdf[2, :8] == 0.0) and np.all(sdf[2, 8:, 3] <= 0)
    dev = DeviceLifDataset.from_dataset(ds, "cpu")
    sdf_d, _ = dev.sample(torch.tensor([0, 1, 2]), torch.Generator().manual_seed(0))
    assert torch.all(sdf_d[2, :8] == 0.0) and torch.all(sdf_d[2, 8:, 3] <= 0)


def test_perturb_normal_cone():
    n = np.tile([[0.0, 0.0, 1.0]], (500, 1))
    p = perturb_normal(n, np.deg2rad(30.0), np.random.RandomState(0))
    assert np.all(p @ np.array([0.0, 0.0, 1.0]) > np.cos(np.deg2rad(30.0)) - 1e-6)
    assert np.allclose(np.linalg.norm(p, axis=1), 1.0, atol=1e-6)


def test_device_sampler_pool_semantics(lif_dirs):
    """Mirrors tests/test_device_lif.py on CPU tensors: balanced signs, rows
    drawn from each LIF's own pools, unit normals."""
    _, tdir = lif_dirs
    ds = LifDataset(str(tdir), num_sample=128, num_surface_sample=32)
    dev = DeviceLifDataset.from_dataset(LifCombinedDataset(ds), "cpu")
    idxs = torch.arange(8)
    sdf, surf = dev.sample(idxs, torch.Generator().manual_seed(0))
    assert sdf.shape == (8, 128, 4) and surf.shape == (8, 32, 6)
    pk = ds._ensure_packed()
    for b in range(8):
        pos = np.asarray(pk["pos"][pk["pos_off"][b]:pk["pos_off"][b + 1]])
        neg = np.asarray(pk["neg"][pk["neg_off"][b]:pk["neg_off"][b + 1]])
        srf = np.asarray(pk["surf"][pk["surf_off"][b]:pk["surf_off"][b + 1]])
        for rows, pool in ((sdf[b, :64], pos), (sdf[b, 64:], neg), (surf[b], srf)):
            rows = rows.numpy()
            assert (rows[:, None, :] == pool[None]).all(-1).any(1).all()
        assert (sdf[b, :64, 3] > 0).all() and (sdf[b, 64:, 3] <= 0).all()
    # uniform choice within a LIF: every row of a small pool is drawn
    many, _ = dev.sample(torch.zeros(64, dtype=torch.int64), torch.Generator().manual_seed(1))
    n_pos = int(pk["pos_off"][1] - pk["pos_off"][0])
    assert len(torch.unique(many[:, :64, 3])) > 0.9 * min(n_pos, 64 * 64)
    with pytest.raises(ValueError):
        DeviceLifDataset.from_dataset(LifCombinedDataset(ds, ds), "cpu")


@pytest.mark.parametrize("aug", ["Y", "X", "Z", "3D"])
def test_device_sampler_augment_preserves_geometry(lif_dirs, aug):
    _, tdir = lif_dirs
    plain = DeviceLifDataset(LifDataset(str(tdir), num_sample=64, num_surface_sample=32), "cpu")
    augd = DeviceLifDataset(LifDataset(str(tdir), num_sample=64, num_surface_sample=32,
                                       augment_rotation=aug, augment_noise=(0.025, 40.0)), "cpu")
    idxs = torch.tensor([0, 3, 3, 11])
    sdf0, surf0 = plain.sample(idxs, torch.Generator().manual_seed(1))
    sdf, surf = augd.sample(idxs, torch.Generator().manual_seed(1))
    # the same row draws come first, so the rows are the plain ones rotated
    np.testing.assert_allclose(sdf[..., :3].norm(dim=-1), sdf0[..., :3].norm(dim=-1), atol=1e-5)
    assert torch.equal(sdf[..., 3], sdf0[..., 3])
    assert not torch.allclose(sdf[..., :3], sdf0[..., :3])
    np.testing.assert_allclose(surf[..., 3:6].norm(dim=-1), 1.0, atol=1e-5)
    # surface noise: 0.025 per axis on top of the rotation
    jitter = surf[..., :3].norm(dim=-1) - surf0[..., :3].norm(dim=-1)
    assert 0.01 < jitter.std().item() < 0.05
    # the normals stay within the 40-degree cone of the rotated originals
    if aug != "3D":
        assert (surf[..., 3:6].norm(dim=-1) > 0.99).all()
