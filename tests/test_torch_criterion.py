"""The port's training losses and learning-rate schedules against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models import criterion as jcrit
from nerf_fusion_tpu.models.decoder import DecoderConfig as JDecoderConfig
from nerf_fusion_tpu.models.decoder import apply_decoder, init_decoder as jax_init_decoder
from nerf_fusion_tpu.trainer import lr_schedule as jsched
from nerf_fusion_tpu_torch.models import criterion
from nerf_fusion_tpu_torch.models import io
from nerf_fusion_tpu_torch.models.decoder import DecoderConfig, init_decoder
from nerf_fusion_tpu_torch.trainer import lr_schedule
from nerf_fusion_tpu_torch.utils.config import dict_to_args

TOL = 1e-5
ARGS = dict_to_args(dict(enforce_minmax=True, clamping_distance=0.2, code_reg_lambda=1e-2,
                         siren_sdf_in=1.0, siren_sdf_out=0.5, siren_normal=0.3,
                         siren_eikonal=0.7))


def _inputs(n=512, seed=0):
    rng = np.random.RandomState(seed)
    pd = (rng.randn(n, 1) * 0.3).astype(np.float32)
    std = (0.05 + rng.rand(n, 1)).astype(np.float32)
    gt = (rng.randn(n, 1) * 0.3).astype(np.float32)
    lat = rng.randn(n, 29).astype(np.float32)
    return pd, std, gt, lat


def _close(out_t, out_j):
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]), rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("minmax", [True, False])
@pytest.mark.parametrize("epoch", [1, 50, 250])
def test_losses_match_jax(minmax, epoch):
    args = dict_to_args(dict(vars(ARGS), enforce_minmax=minmax))
    pd, std, gt, lat = _inputs()
    info = {"num_sdf_samples": 512, "epoch": epoch}
    t = {k: torch.as_tensor(v) for k, v in dict(pd=pd, std=std, gt=gt, lat=lat).items()}
    j = {k: jnp.asarray(v) for k, v in dict(pd=pd, std=std, gt=gt, lat=lat).items()}
    _close(criterion.l1_loss(args, info, pd_sdf=t["pd"], gt_sdf=t["gt"]),
           jcrit.l1_loss(args, info, pd_sdf=j["pd"], gt_sdf=j["gt"]))
    _close(criterion.neg_log_likelihood(args, info, pd_sdf=t["pd"], pd_sdf_std=t["std"],
                                        gt_sdf=t["gt"]),
           jcrit.neg_log_likelihood(args, info, pd_sdf=j["pd"], pd_sdf_std=j["std"],
                                    gt_sdf=j["gt"]))
    _close(criterion.reg_loss(args, info, latent_vecs=t["lat"]),
           jcrit.reg_loss(args, info, latent_vecs=j["lat"]))


def test_siren_loss_matches_jax_through_a_decoder():
    """The input gradient by autograd (create_graph) against jax.vmap(jax.grad)
    on the same decoder; and the loss's own gradient is finite."""
    latent, specs = 8, dict(dims=[16, 16], norm_layers=[0, 1, 2], latent_in=[1],
                            weight_norm=True)
    jcfg = JDecoderConfig(latent, **specs)
    jp = jax.tree_util.tree_map(np.asarray, jax_init_decoder(jax.random.PRNGKey(2), jcfg))
    dec = init_decoder(DecoderConfig(latent, **specs), torch.Generator().manual_seed(0))
    dec.load_state_dict(io.train_params_from_jax(jp, {}, {})[0])
    dec.eval()
    rng = np.random.RandomState(1)
    lat = rng.randn(1, latent).astype(np.float32) * 0.5       # one shape code
    xyz = rng.randn(64, 3).astype(np.float32) * 0.5
    gt = np.zeros((64, 3), np.float32)
    gt[:32] = rng.randn(32, 3)
    gt[:32] /= np.linalg.norm(gt[:32], axis=1, keepdims=True)
    info = {"num_sdf_samples": 64}

    def sdf_fn(c):
        return apply_decoder(jp, jcfg, jnp.concatenate(
            [jnp.broadcast_to(jnp.asarray(lat), (c.shape[0], latent)), c], 1))[0]

    out_j = jcrit.siren_loss(ARGS, info, pd_sdf=sdf_fn(jnp.asarray(xyz)),
                             coords=jnp.asarray(xyz), gt_sdf=jnp.asarray(gt), sdf_fn=sdf_fn)
    coords = torch.as_tensor(xyz).requires_grad_()
    pd, _ = dec(torch.cat([torch.as_tensor(lat).expand(64, latent), coords], 1))
    out_t = criterion.siren_loss(ARGS, info, pd_sdf=pd, coords=coords,
                                 gt_sdf=torch.as_tensor(gt))
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].item(), float(out_j[k]), rtol=TOL, atol=1e-7)
    torch.stack(list(out_t.values())).sum().backward()
    # the second derivative reaches every layer that computes the SDF
    for name, p in dec.named_parameters():
        if not name.startswith("unc."):
            assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_siren_loss_on_a_plane():
    """The perfect SDF of the plane z = 0 (as tests/test_rays_criterion.py)."""
    coords = torch.as_tensor(np.random.RandomState(0).randn(32, 3).astype(np.float32))
    coords[:16, 2] = 0.0
    coords.requires_grad_()
    gt = torch.zeros(32, 3)
    gt[:16, 2] = 1.0
    out = criterion.siren_loss(ARGS, {"num_sdf_samples": 32}, pd_sdf=coords[:, 2:3],
                               coords=coords, gt_sdf=gt)
    assert float(out["sdf_in"]) < 1e-6
    assert float(out["normal"]) < 1e-6
    assert float(out["eikonal"]) < 1e-6
    assert float(out["sdf_out"]) > 0


def test_get_losses_names():
    names = ["l1_loss", "neg_log_likelihood", "reg_loss", "siren_loss"]
    assert [f.__name__ for f in criterion.get_losses(names)] == \
        [f.__name__ for f in jcrit.get_losses(names)]


def test_schedules_match_jax():
    specs = [{"Type": "Step", "Initial": 1e-3, "Interval": 80, "Factor": 0.4},
             {"Type": "Warmup", "Initial": 1e-4, "Final": 1e-3, "Length": 30},
             {"Type": "Constant", "Value": 5e-4}]
    args = dict_to_args({"lr_schedule": specs})
    port = lr_schedule.get_learning_rate_schedules(args)
    ref = jsched.get_learning_rate_schedules(args)
    for epoch in [0, 1, 29, 30, 31, 79, 80, 81, 160, 599, 600]:
        assert [s.get_learning_rate(epoch) for s in port] == \
            [s.get_learning_rate(epoch) for s in ref]
    with pytest.raises(ValueError):
        lr_schedule.get_learning_rate_schedules(dict_to_args({"lr_schedule": [{"Type": "Cos"}]}))
