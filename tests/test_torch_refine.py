"""The port's latent refinement and the decoder's VJP against the JAX package.

* ``decoder_vjp_plain`` (the ``decoder_vjp`` kernel's algorithm) against
  ``jax.vjp`` of ``apply_decoder`` on the same rows, weights and upstream
  gradients: within 1e-5 of the largest entry (the weights are folded in
  float64 here, per call in f32 in JAX).  Rows at exact ReLU kinks (a zero
  pre-activation) take the zero derivative in both, as ``jax.nn.relu``
  does; ``DecoderFn`` passes ``gradcheck`` in float64 on the plain path.
* ``refine_latents_core`` fed JAX's own jitter draw, on the fixture of
  ``tests/test_refine.py``: the refined mask equal, the loss and the latent
  gradient of step 1 within 1e-5 (JAX's loss restated from
  ``nerf_fusion_tpu/system/refine.py:52-90``), the latents after 5 Adam
  steps as stated at ``test_refine_matches_jax``.
* The three JAX tests mirrored (fit not degraded, the de-integration merge
  identity, the async round trip, here equal to the sync result), and the
  map's refinement with a pose on world-frame points (the JAX map hands
  the camera-frame points to its refinement when given a pose).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops import voxel as jvox
from nerf_fusion_tpu.system import map as jmap
from nerf_fusion_tpu.system import refine as jrefine
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.models.decoder import Decoder
from nerf_fusion_tpu_torch.ops import mlp
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system import refine as trefine
from nerf_fusion_tpu_torch.system.worker import Worker
from nerf_fusion_tpu_torch.utils.config import dict_to_args

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
HI = jax.lax.Precision.HIGHEST
MAP_ARGS = dict(bound_min=[0.0, 0.0, 0.0], bound_max=[1.0, 1.0, 1.0], voxel_size=0.1,
                prune_min_vox_obs=4, ignore_count_th=16.0, encoder_count_th=100.0,
                latent_capacity=1024, alloc_capacity=256, optim_n_iters=5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _plane(n=4000, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(0.35, 0.65, n), rng.uniform(0.35, 0.65, n),
                    np.full(n, 0.52)], axis=1).astype(np.float32)
    return pts, np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))


@pytest.fixture(scope="module")
def fused():
    """The fixture of tests/test_refine.py, fused by the JAX package and
    copied into the port's map."""
    jm, margs = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    args = dict_to_args(MAP_ARGS)
    jv = jmap.SparseVoxelMap(jm, args, latent_dim=margs.code_length)
    tv = tmap.SparseVoxelMap(tm, args, margs.code_length, "cpu")
    pts, nrm = _plane()
    jv.integrate_keyframe(pts, nrm)
    tv._assign(tmap.MapState(*(torch.tensor(np.asarray(a)) for a in jv.state)))
    return jv, tv, pts, nrm


def _vjp_jax(params, cfg, x, g):
    _, f = jax.vjp(lambda v: jnp.concatenate(apply_decoder(params, cfg, v, precision=HI), 1),
                   jnp.asarray(x))
    return np.asarray(f(jnp.asarray(g))[0])


def test_decoder_vjp_plain_matches_jax():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    rng = np.random.RandomState(0)
    x = (rng.randn(600, 32) * 0.4).astype(np.float32)
    g = rng.randn(600, 2).astype(np.float32)
    want = _vjp_jax(jm.decoder_params, jm.decoder_config, x, g)
    got = mlp.decoder_vjp(torch.as_tensor(x), torch.as_tensor(g), tm.decoder.packed,
                          tm.decoder.mats).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_decoder_vjp_at_relu_kinks_matches_jax():
    """Half of lin0's units without bias and input rows that are zero but
    for a few entries: those units' pre-activations are exactly 0 on the
    zero rows; both packages take the derivative there as 0."""
    jm, _ = jax_load_model(CKPT, 300)
    params = _np(jm.decoder_params)
    params["lin0"] = dict(params["lin0"])
    b = params["lin0"]["b"].copy()
    b[::2] = 0.0
    params["lin0"]["b"] = b
    dec = Decoder(mlp.fold_decoder_weights(params))
    rng = np.random.RandomState(1)
    x = np.zeros((64, 32), np.float32)
    x[32:, 29:] = rng.uniform(-0.5, 0.5, (32, 3))
    g = rng.randn(64, 2).astype(np.float32)
    a0 = torch.as_tensor(x) @ dec.mats[0][0] + dec.mats[0][1]
    assert int((a0[:32] == 0).sum()) == 32 * 64          # the kinks are exact
    want = _vjp_jax(jax.tree_util.tree_map(jnp.asarray, params), jm.decoder_config, x, g)
    got = mlp.decoder_vjp_plain(torch.as_tensor(x), torch.as_tensor(g), dec.mats).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_decoder_fn_gradcheck_float64():
    tm, _ = load_model(CKPT, 300)
    dec = tm.decoder
    mats64 = [(w.double(), b.double()) for w, b in dec.mats]
    x = (0.4 * torch.randn(6, 32, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: mlp.DecoderFn.apply(v, dec.packed, mats64), (x,))


def _jax_loss(latents, state, cfg, params, dec_cfg, points, normals, valid, gt_sdf,
              code_reg_lambda=1e-2):
    """JAX's refinement loss with its jitter given (refine.py:52-90)."""
    C = latents.shape[0]
    xyz_norm = (points - jnp.asarray(cfg.bound_min, jnp.float32)[None]) / cfg.voxel_size
    eligible = (state.positions >= 0) & (state.obs_count >= cfg.encoder_count_th) \
        & (~state.optimized)
    tgt = jnp.ceil(xyz_norm[:, None, :] + jnp.asarray(jmap._CORNER_OFFSETS)[None]) \
        .astype(jnp.int32) - 1
    tgt = jnp.clip(tgt, 0, jnp.asarray(cfg.n_xyz, jnp.int32)[None, None] - 1)
    rel = xyz_norm[:, None, :] - tgt.astype(jnp.float32) - 0.5
    tgt_slot = state.indexer[jvox.linearize_id(tgt, cfg.n_xyz)]
    slot_c = jnp.clip(tgt_slot, 0, C - 1)
    contrib = valid[:, None] & (tgt_slot >= 0) & eligible[slot_c]
    pos = rel + gt_sdf[..., None] * normals[:, None, :]
    flat_gt = jnp.clip(gt_sdf.reshape(-1), -0.2, 0.2)
    flat_m = contrib.reshape(-1).astype(jnp.float32)
    n_samples = jnp.maximum(jnp.sum(flat_m), 1.0)
    sdf, std = apply_decoder(params, dec_cfg, jnp.concatenate(
        [latents[slot_c.reshape(-1)], pos.reshape(-1, 3)], axis=1))
    mu = jnp.clip(sdf[:, 0], -0.2, 0.2)
    sig = std[:, 0]
    nll = 0.5 * ((flat_gt - mu) / sig) ** 2 + jnp.log(sig)
    reg = code_reg_lambda * jnp.sum(jnp.linalg.norm(latents, axis=1) * eligible) / n_samples
    return jnp.sum(nll * flat_m) / n_samples + reg


def _folded_params(decoder):
    """The port's folded decoder matrices as a JAX pytree without weight
    norm: both packages then decode with the same f32 weights (JAX folds
    weight norm per call in f32, the port once in float64), and a sample
    near a ReLU kink or the +-0.2 clamp sees the same side in both."""
    names = [f"lin{i}" for i in range(5)] + ["unc"]
    return {n: {"w": jnp.asarray(w.T.numpy()), "b": jnp.asarray(b.numpy())}
            for n, (w, b) in zip(names, decoder.mats)}


def test_refine_matches_jax(fused):
    """JAX's jitter fed to the port's core, both on the port's folded
    weights (``_folded_params``).  Step 1's loss and gradient
    within 1e-5 (of the gradient's largest entry).  After 5 steps: Adam
    divides each entry's mean gradient by its own root mean square, so
    where an entry's gradient is small or changes sign between steps the
    summation order's 1e-7 in g moves the step by a fraction of lr = 0.01;
    the latents are held within 1e-4 on 99 % of the eligible entries and
    within 1e-3 (a tenth of one step) on all (measured: median 1.2e-7,
    99 % 7.9e-5, max 5.4e-4 of 928 entries).  JAX's non-eligible zero rows come out NaN
    (the norm's derivative at 0, masked by a product), so only eligible
    rows are compared."""
    jv, tv, pts, nrm = fused
    key = jax.random.PRNGKey(0)
    n = len(pts)
    gt = np.array(jax.random.normal(key, (n, 8)) * 0.05)
    valid = np.ones(n, bool)
    params = _folded_params(tv.model.decoder)
    jres = jrefine.refine_latents(jv.state, jv.cfg, params, jv.model.decoder_config,
                                  jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid), key,
                                  n_iters=5)
    tres = trefine.refine_latents_core(tv.state, tv.cfg, tv.model.decoder, torch.as_tensor(pts),
                                       torch.as_tensor(nrm), torch.as_tensor(valid),
                                       torch.as_tensor(gt), n_iters=5)
    elig = np.asarray(jres.refined)
    assert elig.sum() > 0 and np.array_equal(tres.refined.numpy(), elig)

    jloss, jgrad = jax.value_and_grad(_jax_loss)(
        jv.state.latents, jv.state, jv.cfg, params, jv.model.decoder_config,
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid), jnp.asarray(gt))
    lat = tv.state.latents.clone().requires_grad_()
    t = trefine.refine_targets(tv.state, tv.cfg, torch.as_tensor(pts), torch.as_tensor(nrm),
                               torch.as_tensor(valid), torch.as_tensor(gt))
    loss, _ = trefine.refine_loss(lat, tv.model.decoder, t, 1e-2)
    (tgrad,) = torch.autograd.grad(loss, lat)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jg = np.asarray(jgrad)[elig]
    assert np.abs(tgrad.numpy()[elig] - jg).max() <= 1e-5 * np.abs(jg).max()

    d = np.abs(tres.latents.numpy()[elig] - np.asarray(jres.latents)[elig])
    assert (d <= 1e-4).mean() >= 0.99 and d.max() <= 1e-3


def test_refine_improves_surface_fit(fused):
    _, tv, pts, nrm = fused
    q = torch.as_tensor(pts[:512])
    sdf0, _, valid0 = tmap.get_sdf(tv.state, tv.cfg, tv.model.decoder, q)
    before = float(sdf0.abs()[valid0].mean())
    res = trefine.refine_latents(tv.state, tv.cfg, tv.model.decoder, torch.as_tensor(pts),
                                 torch.as_tensor(nrm), torch.ones(len(pts), dtype=torch.bool),
                                 torch.Generator().manual_seed(0), n_iters=5)
    assert int(res.refined.sum()) > 0
    st = trefine.merge_refined(tv.state, res, deintegrate=False)
    sdf1, _, valid1 = tmap.get_sdf(st, tv.cfg, tv.model.decoder, q)
    assert float(sdf1.abs()[valid1].mean()) <= before * 1.05
    assert bool(st.optimized.any())


def test_deintegration_merge_identity(fused):
    """With unchanged counts the de-integration merge equals the plain
    replace; JAX's merge on the same result agrees."""
    jv, tv, pts, nrm = fused
    res = trefine.refine_latents(tv.state, tv.cfg, tv.model.decoder, torch.as_tensor(pts),
                                 torch.as_tensor(nrm), torch.ones(len(pts), dtype=torch.bool),
                                 torch.Generator().manual_seed(1), n_iters=2)
    a = trefine.merge_refined(tv.state, res, deintegrate=False)
    b = trefine.merge_refined(tv.state, res, deintegrate=True)
    m = res.refined
    assert torch.allclose(a.latents[m], b.latents[m], atol=1e-5)
    jres = jrefine.RefineResult(*(jnp.asarray(t.numpy()) for t in res))
    for de in (False, True):
        want = jrefine.merge_refined(jv.state, jres, deintegrate=de)
        got = trefine.merge_refined(tv.state, res, deintegrate=de)
        assert np.array_equal(got.optimized.numpy(), np.asarray(want.optimized))
        assert np.abs(got.latents.numpy() - np.asarray(want.latents)).max() <= 1e-6


def test_async_refiner_roundtrip_equals_sync(fused):
    _, tv, pts, nrm = fused
    args = (tv.state, tv.cfg, tv.model.decoder, torch.as_tensor(pts), torch.as_tensor(nrm),
            torch.ones(len(pts), dtype=torch.bool))
    gt = trefine.draw_jitter(len(pts), torch.Generator().manual_seed(2), "cpu")
    r = trefine.AsyncRefiner(Worker("cpu"))
    r.dispatch(*args, gt, n_iters=2)
    r.join()
    res = r.collect()
    assert res is not None and not r.busy() and r.collect() is None
    ref = trefine.refine_latents_core(*args, gt, n_iters=2)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)


def test_map_refines_world_frame_points_with_a_pose():
    """``integrate_keyframe(pose=..., do_optimize=True)`` on camera-frame
    points refines exactly as the same frame given in the world frame
    without a pose; the refinement sees samples in both."""
    tm, margs = load_model(CKPT, 300)
    args = dict_to_args(dict(MAP_ARGS, encoder_count_th=20.0))
    pts, nrm = _plane(3000, seed=3)
    c, s = np.cos(0.3), np.sin(0.3)
    R = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float32)
    t = torch.tensor([0.05, -0.02, 0.03])
    cam = torch.as_tensor(pts) - t
    cam = cam @ R                                   # world = R cam + t
    cam_n = torch.as_tensor(nrm) @ R
    maps = []
    for posed in (True, False):
        vm = tmap.SparseVoxelMap(tm, args, margs.code_length, "cpu")
        world = cam @ R.T + t[None, :]
        world_n = cam_n @ R.T
        if posed:
            vm.integrate_keyframe(cam, cam_n, pose=(R, t), do_optimize=True)
        else:
            vm.integrate_keyframe(world, world_n, do_optimize=True)
        maps.append(vm)
    a, b = maps
    assert a.refine_summary()[0]["sampled"] > 0
    assert a.refine_summary()[0]["sampled"] == b.refine_summary()[0]["sampled"]
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
