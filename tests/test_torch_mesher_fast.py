"""The port's fast mesh decode (``mesh_fast``) against the JAX package.

* ``_coarse_offsets`` and ``_upsample_blend_matrix``: the port's own numpy
  copies, bitwise equal to JAX's.
* ``decode_cubes(fast=True)`` against JAX's ``_decode_cubes(fast=True,
  precision="high")`` on the plane fixture of ``tests/test_mesher.py``:
  the upsampled coarse grid within 1e-5, the re-decode selection (|sdf| <
  0.05) equal but for samples within 1e-5 of the threshold, which are
  left out of both comparisons and counted; the final grids within 1e-5.
* ``fast_mode_close_to_full`` mirrored (triangle counts within 20 %,
  median height within 1 cm), and the ``mesh_fast`` config key threaded
  through the pipeline to the Mesher (default off).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.system import map as jmap
from nerf_fusion_tpu.system import mesher as jmesher
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system import mesher as tmesher
from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
from nerf_fusion_tpu_torch.utils import config as exp_util
from nerf_fusion_tpu_torch.utils.config import dict_to_args

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "ckpt/default/hyper.json"
TOL = 1e-5
MAP_ARGS = dict(bound_min=[0.0, 0.0, 0.0], bound_max=[1.0, 1.0, 1.0], voxel_size=0.1,
                prune_min_vox_obs=4, ignore_count_th=16.0, encoder_count_th=600.0,
                latent_capacity=2048, alloc_capacity=512)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plane():
    """The plane of tests/test_mesher.py fused by the JAX package, copied
    into the port's map."""
    jm, margs = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    args = dict_to_args(MAP_ARGS)
    jv = jmap.SparseVoxelMap(jm, args, latent_dim=margs.code_length)
    tv = tmap.SparseVoxelMap(tm, args, margs.code_length, "cpu")
    rng = np.random.RandomState(0)
    n = 6000
    pts = np.stack([rng.uniform(0.3, 0.7, n), rng.uniform(0.3, 0.7, n),
                    np.full(n, 0.55) + rng.randn(n) * 0.002], axis=1).astype(np.float32)
    nrm = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    jv.integrate_keyframe(pts, nrm)
    tv._assign(tmap.MapState(*(torch.tensor(np.asarray(a)) for a in jv.state)))
    return jv, tv


@pytest.mark.parametrize("r", [2, 3, 4, 5, 8])
def test_offsets_and_blend_matrix_equal_jax(r):
    assert np.array_equal(tmesher._coarse_offsets(r), jmesher._coarse_offsets(r))
    assert np.array_equal(tmesher._upsample_blend_matrix(r), jmesher._upsample_blend_matrix(r))
    assert np.array_equal(tmesher._sample_offsets(r), jmesher._sample_offsets(r))


def _jax_upsampled(params, cfg, lat, r):
    """JAX's coarse decode and upsample (mesher.py:281-299)."""
    B = lat.shape[0]
    n_lo = r ** 3
    offs = jnp.asarray(jmesher._coarse_offsets(r))
    sdf, _ = apply_decoder(params, cfg, jnp.concatenate(
        [jnp.repeat(lat, n_lo, axis=0), jnp.tile(offs, (B, 1))], axis=1))
    T = jnp.asarray(jmesher._upsample_blend_matrix(r))
    return np.asarray(jnp.matmul(sdf[:, 0].reshape(B, n_lo), T.T,
                                 precision=jax.lax.Precision.HIGHEST).reshape(-1))


@pytest.mark.parametrize("reeval_budget", [65536, 2048])
def test_fast_decode_matches_jax(plane, reeval_budget):
    """One 512-voxel chunk: the fixture's confident voxels, padded (valid
    False) with copies of the first.  At the small budget the selection is
    truncated, in the same order in both (8 samples lie within 1e-5 of the
    threshold here, on the same side in both packages)."""
    jv, tv = plane
    r = 4
    obs = tv.state.obs_count
    slots = torch.nonzero((tv.state.positions >= 0) & (obs > 16.0))[:, 0]
    assert 20 < len(slots) <= 512
    lat = tv.state.latents[torch.cat([slots, slots[:1].repeat(512 - len(slots))])]
    valid = torch.arange(512) < len(slots)

    up_t = tmesher.upsample_coarse(tv.model.decoder, lat, r)[0].numpy()
    up_j = _jax_upsampled(jv.model.decoder_params, jv.model.decoder_config,
                          jnp.asarray(lat.numpy()), r)
    assert np.abs(up_t - up_j).max() <= TOL
    n_hi = (2 * r) ** 3
    vrep = np.repeat(valid.numpy(), n_hi)
    near_t, near_j = (np.abs(up_t) < 0.05) & vrep, (np.abs(up_j) < 0.05) & vrep
    edge = np.abs(np.abs(up_j) - 0.05) < TOL
    print(f"samples within {TOL} of the 0.05 threshold: {int(edge.sum())}")
    assert np.array_equal(near_t[~edge], near_j[~edge]) and near_j.sum() > 1000
    if reeval_budget < near_j.sum():
        # a truncated selection shifts after any flipped sample: here none flips
        assert np.array_equal(near_t, near_j)

    sdf_t, std_t = tmesher.decode_cubes(tv.model.decoder, lat, r, fast=True, valid_b=valid,
                                        reeval_budget=reeval_budget)
    sdf_j, std_j = jmesher._decode_cubes(jv.model.decoder_params, jv.model.decoder_config,
                                         jnp.asarray(lat.numpy()), jnp.asarray(valid.numpy()),
                                         r, True, reeval_budget, "high")
    keep = ~edge.reshape(512, 2 * r, 2 * r, 2 * r)
    assert np.abs(sdf_t.numpy() - np.asarray(sdf_j))[keep].max() <= TOL
    assert np.abs(std_t.numpy() - np.asarray(std_j))[keep].max() <= TOL


def test_fast_mode_close_to_full(plane):
    _, tv = plane
    m_full = tmesher.Mesher(tv, max_n_triangles=1 << 15)
    full = m_full.extract(4, max_std=0.3, fast=False, no_cache=True).copy()
    m_fast = tmesher.Mesher(tv, max_n_triangles=1 << 15, mesh_fast=True)
    fast = m_fast.extract(4, max_std=0.3, no_cache=True)      # the Mesher's mode
    assert len(fast) > 0 and len(full) > 50
    assert abs(len(fast) - len(full)) / len(full) < 0.2
    assert abs(np.median(fast.reshape(-1, 3)[:, 2]) - np.median(full.reshape(-1, 3)[:, 2])) \
        < 0.01
    # the fused (incremental) path in fast mode agrees with the chunked one
    tv.updated_slots[:] = True
    m_inc = tmesher.Mesher(tv, max_n_triangles=1 << 15, mesh_fast=True)
    inc = m_inc.extract(4, max_std=0.3)
    assert len(inc) == len(fast)


def test_pipeline_threads_mesh_fast():
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    model, args.model = load_model(REPO / args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.mapping.latent_capacity, args.mapping.alloc_capacity = 1024, 512
    args.tracking = exp_util.dict_to_args(args.tracking)
    pipe = FusionPipeline(model, args, "cpu", point_budget=1024)
    assert pipe.mesh_fast is False and pipe.mesher.mesh_fast is False
    args.mesh_fast = True
    pipe2 = FusionPipeline(model, args, "cpu", point_budget=1024)
    assert pipe2.mesh_fast is True and pipe2.mesher.mesh_fast is True
    assert pipe2.mesher.reeval_fraction == 0.25
