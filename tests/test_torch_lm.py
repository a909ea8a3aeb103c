"""The port's Levenberg-Marquardt point tracker and SE(3) log against the
JAX package.

Both packages fuse the same asymmetric scene (two spheres and a plane
patch, 3 x 3000 points, a 12^3 map of 0.1 m voxels; their latents agree
to f32 rounding) and track the same points from the same start.  After 5
iterations R and t agree within 1e-4 and the energy within rtol 1e-3
(f32 sums in another order); 25 iterations recover a perturbed pose within
the JAX test's bar (1 cm, 1 degree; ``tests/test_lm_tracker.py``).
``inverse`` and ``se3_log`` agree with JAX's within 1e-6 and round-trip.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.system.map import SparseVoxelMap as JaxMap
from nerf_fusion_tpu.system.tracker import track_points_lm as jax_lm
from nerf_fusion_tpu.utils import se3_jax as sj
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.system.map import SparseVoxelMap
from nerf_fusion_tpu_torch.system.tracker import track_points_lm
from nerf_fusion_tpu_torch.utils import se3_torch as st
from nerf_fusion_tpu_torch.utils.config import dict_to_args
from nerf_fusion_tpu_torch.utils.se3 import Isometry

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[0.0, 0.0, 0.0], bound_max=[1.2, 1.2, 1.2], voxel_size=0.1,
                prune_min_vox_obs=4, ignore_count_th=8.0, encoder_count_th=600.0,
                latent_capacity=4096, alloc_capacity=1024)
XI = np.asarray([0.02, -0.015, 0.02, 0.015, -0.02, 0.01])     # the pose error

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test processes run side by side (pytest-xdist)
    and the small shapes here gain nothing from a thread pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    n = 3000
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    plane = np.concatenate([rng.uniform(0.2, 1.0, (n, 2)), np.full((n, 1), 0.25)], axis=1)
    pts = np.concatenate([0.45 + 0.18 * d, np.array([0.85, 0.55, 0.75]) + 0.12 * d,
                          plane]).astype(np.float32)
    nrm = np.concatenate([d, d, np.tile([[0.0, 0.0, 1.0]], (n, 1))]).astype(np.float32)
    jm, _ = jax_load_model(CKPT, 300)
    jmap = JaxMap(jm, dict_to_args(MAP_ARGS), latent_dim=29)
    jmap.integrate_keyframe(pts, nrm)
    tm, _ = load_model(CKPT, 300)
    tmap = SparseVoxelMap(tm, dict_to_args(MAP_ARGS), 29, "cpu")
    tmap.integrate_keyframe(pts, nrm)
    wrong = Isometry.from_twist(XI)
    obs = ((pts - wrong.t) @ wrong.q.rotation_matrix)[::2].astype(np.float32)
    return dict(jm=jm, jmap=jmap, tmap=tmap, obs=obs, wrong=wrong)


def _lm_both(s, n_iters):
    obs = s["obs"]
    jR, jt, je = jax_lm(s["jmap"].state, s["jmap"].cfg, s["jm"].decoder_params,
                        s["jm"].decoder_config, jnp.asarray(obs),
                        jnp.ones((len(obs),), bool), jnp.eye(3), jnp.zeros(3), n_iters=n_iters)
    m = s["tmap"]
    tR, tt, te = track_points_lm(m.state, m.cfg, m.model.decoder, torch.from_numpy(obs),
                                 torch.ones(len(obs), dtype=torch.bool), torch.eye(3),
                                 torch.zeros(3), n_iters=n_iters, bound_min=m.bound_min)
    return (np.asarray(jR), np.asarray(jt), float(je)), (tR, tt, te)


def test_lm_matches_jax(scene):
    (jR, jt, je), (tR, tt, te) = _lm_both(scene, 5)
    assert np.abs(tR.numpy() - jR).max() < 1e-4
    assert np.abs(tt.numpy() - jt).max() < 1e-4
    assert te.shape == () and np.isfinite(float(te))
    assert abs(float(te) - je) <= 1e-3 * abs(je)
    assert not np.allclose(tR.numpy(), np.eye(3), atol=1e-4)     # it moved


def test_lm_recovers_perturbed_pose(scene):
    m = scene["tmap"]
    obs = torch.from_numpy(scene["obs"])
    R, t, energy = track_points_lm(m.state, m.cfg, m.model.decoder, obs,
                                   torch.ones(len(obs), dtype=torch.bool), torch.eye(3),
                                   torch.zeros(3), n_iters=25)
    rec = Isometry.from_matrix(R.double().numpy(), t.double().numpy(), ortho=True)
    wrong = scene["wrong"]
    err_t = np.linalg.norm(rec.t - wrong.t)
    dR = rec.q.rotation_matrix.T @ wrong.q.rotation_matrix
    err_r = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert err_t < 0.01, f"translation err {err_t}"
    assert err_r < 1.0, f"rotation err {err_r}"


def test_se3_inverse_and_log_match_jax():
    rng = np.random.default_rng(7)
    xi = rng.normal(0, 0.2, (10, 6)).astype(np.float32)
    jR, jt = sj.se3_exp(jnp.asarray(xi))
    R, t = torch.from_numpy(np.array(jR)), torch.from_numpy(np.array(jt))
    iR, it_ = st.inverse(R, t)
    jiR, jit = sj.inverse(jR, jt)
    assert np.abs(iR.numpy() - np.asarray(jiR)).max() < 1e-6
    assert np.abs(it_.numpy() - np.asarray(jit)).max() < 1e-6
    for k in range(len(xi)):            # JAX's se3_log takes one pose
        ref = np.asarray(sj.se3_log(jR[k], jt[k]))
        got = st.se3_log(R[k], t[k]).numpy()
        assert np.abs(got - ref).max() < 1e-6
        np.testing.assert_allclose(got, xi[k], atol=2e-5)
    # batched, and exp(log(T)) == T; T o T^-1 == I
    log = st.se3_log(R, t)
    R2, t2 = st.se3_exp(log)
    assert np.abs(R2.numpy() - R.numpy()).max() < 1e-6
    assert np.abs(t2.numpy() - t.numpy()).max() < 1e-6
    cR, ct = st.compose(R, t, iR, it_)
    np.testing.assert_allclose(cR.numpy(), np.broadcast_to(np.eye(3), cR.shape), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), 0.0, atol=1e-6)
