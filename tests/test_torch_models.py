"""Port's decoder/encoder (plain path on the CPU) against the JAX package.

The same numpy inputs go through ``apply_decoder``/``apply_encoder``, the
interpret-mode Pallas kernels and the port's modules built from the same
``ckpt/default`` weights.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.encoder import apply_encoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops.pallas_mlp import (decoder_forward_pallas,
                                            encoder_forward_pallas)
from nerf_fusion_tpu.system.map import MapConfig as JMapConfig
from nerf_fusion_tpu.system.map import get_sdf as jax_get_sdf
from nerf_fusion_tpu.system.map import init_state as jax_init_state
from nerf_fusion_tpu_torch.models.io import load_model, params_from_jax
from nerf_fusion_tpu_torch.ops import mlp
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
# Both sides compute in f32 on the CPU; only the summation order of the
# matrix products (and the folding of weight-norm / BatchNorm into the
# weights, done once here and per call in JAX) differs.
ATOL = 1e-4
# The interpret-mode Pallas kernels: the tolerances of test_pallas_mlp.py.
PALLAS_MAX, PALLAS_MED = 4e-3, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    return jm, tm


def _dec_input(n, seed):
    return np.random.RandomState(seed).randn(n, 32).astype(np.float32) * 0.4


def test_decoder_matches_apply_decoder(models):
    jm, tm = models
    x = _dec_input(1500, 0)
    sdf_j, std_j = apply_decoder(jm.decoder_params, jm.decoder_config, jnp.asarray(x))
    sdf_t, std_t = tm.decoder(torch.as_tensor(x))
    assert sdf_t.shape == (1500, 1) and std_t.shape == (1500, 1)
    assert np.abs(sdf_t.numpy() - np.asarray(sdf_j)).max() <= ATOL
    assert np.abs(std_t.numpy() - np.asarray(std_j)).max() <= ATOL


def test_decoder_matches_pallas_interpret(models):
    jm, tm = models
    x = _dec_input(1500, 1)
    sdf_p, std_p = decoder_forward_pallas(jm.decoder_params, jm.decoder_config,
                                          jnp.asarray(x), interpret=True)
    sdf_t, std_t = tm.decoder(torch.as_tensor(x))
    err = np.abs(sdf_t.numpy() - np.asarray(sdf_p))
    assert err.max() < PALLAS_MAX and np.median(err) < PALLAS_MED
    assert np.abs(std_t.numpy() - np.asarray(std_p)).max() < PALLAS_MAX


def test_encoder_matches_apply_encoder_and_pallas(models):
    jm, tm = models
    x = np.random.RandomState(2).randn(2100, 6).astype(np.float32)
    lat_j, _ = apply_encoder(jm.encoder_params, jm.encoder_bn, jm.encoder_config,
                             jnp.asarray(x), train=False)
    lat_p = encoder_forward_pallas(jm.encoder_params, jm.encoder_bn,
                                   jm.encoder_config, jnp.asarray(x), interpret=True)
    lat_t = tm.encoder(torch.as_tensor(x)).numpy()
    assert lat_t.shape == (2100, 29)
    # encoder latents reach ~10 in magnitude: relative f32 rounding
    assert np.abs(lat_t - np.asarray(lat_j)).max() <= ATOL * max(
        1.0, float(np.abs(lat_j).max()))
    err = np.abs(lat_t - np.asarray(lat_p))
    assert err.max() < PALLAS_MAX and np.median(err) < PALLAS_MED


def test_load_model_equals_params_from_jax(models):
    jm, tm = models
    built = params_from_jax(_np(jm.decoder_params), _np(jm.encoder_params),
                            _np(jm.encoder_bn))
    for a, b in zip(tm.decoder.state_dict().values(), built.decoder.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(tm.encoder.state_dict().values(), built.encoder.state_dict().values()):
        assert torch.equal(a, b)


def test_plain_gradient_matches_autograd(models):
    """The forward-mode input gradient (the kernel's algorithm) equals
    reverse-mode autograd through the plain forward."""
    _, tm = models
    x = torch.as_tensor(_dec_input(700, 3))
    out, grad = mlp.decoder_forward_grad_plain(x, tm.decoder.mats)
    xr = x.clone().requires_grad_(True)
    ref = mlp.decoder_forward_plain(xr, tm.decoder.mats)
    (g,) = torch.autograd.grad(ref[:, 0].sum(), xr)
    assert torch.allclose(out, ref.detach(), atol=1e-6)
    assert torch.allclose(grad, g[:, 29:], atol=1e-5)


def test_get_sdf_gradient_matches_jax_vjp(models):
    """d(sdf/std)/d xyz through the port's get_sdf (autograd Function over
    the decoder's input gradient) against jax.vjp through the JAX get_sdf
    residual, on a map with random latents."""
    jm, tm = models
    margs = dict_to_args(dict(bound_min=[-1.0, -1.0, -1.0], bound_max=[1.0, 1.0, 1.0],
                              voxel_size=0.25, prune_min_vox_obs=0,
                              ignore_count_th=1.0, encoder_count_th=600.0,
                              latent_capacity=512, alloc_capacity=128))
    jcfg = JMapConfig.from_args(margs, 29)
    tcfg = tmap.MapConfig.from_args(margs, 29)
    rng = np.random.RandomState(4)
    n_occ = 512
    indexer = np.arange(jcfg.n_voxels, dtype=np.int32)
    lat = (rng.randn(512, 29) * 0.3).astype(np.float32)
    obs = np.full(512, 5.0, np.float32)
    js = jax_init_state(jcfg)._replace(
        indexer=jnp.asarray(indexer), latents=jnp.asarray(lat),
        positions=jnp.arange(512, dtype=jnp.int32), obs_count=jnp.asarray(obs),
        n_occupied=jnp.asarray(n_occ, jnp.int32))
    ts = tmap.init_state(tcfg, "cpu")._replace(
        indexer=torch.as_tensor(indexer), latents=torch.as_tensor(lat),
        positions=torch.arange(512, dtype=torch.int32),
        obs_count=torch.as_tensor(obs), n_occupied=torch.tensor(n_occ, dtype=torch.int32))
    pts = rng.uniform(-0.95, 0.95, (2000, 3)).astype(np.float32)

    def res_fn(pw):
        sdf, std, valid = jax_get_sdf(js, jcfg, jm.decoder_params, jm.decoder_config, pw)
        return sdf / jax.lax.stop_gradient(std), valid

    r_j, vjp, valid_j = jax.vjp(res_fn, jnp.asarray(pts), has_aux=True)
    g_j = np.asarray(vjp(jnp.ones_like(r_j))[0])

    pw = torch.as_tensor(pts).requires_grad_(True)
    sdf, std, valid_t = tmap.get_sdf(ts, tcfg, tm.decoder, pw)
    r_t = sdf / std.detach()
    (g_t,) = torch.autograd.grad(r_t, pw, torch.ones_like(r_t))
    assert np.array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert np.abs(r_t.detach().numpy() - np.asarray(r_j)).max() <= 1e-3
    # |gradient| reaches ~1e2 (1/voxel_size / std): relative f32 tolerance
    scale = max(1.0, float(np.abs(g_j).max()))
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * scale
