"""The port's trainer against the JAX package's, and its loop on the CPU.

One step of the tiny fixture of ``tests/_train_step_fixture.py`` (B 8,
S 32, M 16, no dropout) from the same weights and batch: the loss terms
and every gradient against JAX's ``make_train_step``, and the parameters
after three Adam steps.  Then the loop itself: ``steps_per_call``, resume,
a loss that falls over two short epochs, and the two entry points.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _train_step_fixture import S, make_batch
from nerf_fusion_tpu.models import io as jio
from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nerf_fusion_tpu.trainer.train import make_optimizers, make_train_step
from nerf_fusion_tpu.utils.config import dict_to_args as jdict_to_args
from nerf_fusion_tpu_torch import data_generator, network_trainer
from nerf_fusion_tpu_torch.models import io
from nerf_fusion_tpu_torch.trainer.train import TrainStep, train
from nerf_fusion_tpu_torch.utils.config import dict_to_args

REPO = Path(__file__).resolve().parent.parent
TINY = dict(
    code_length=8, code_bound=None, network_name="di_decoder",
    network_specs={"dims": [16, 16], "dropout": [], "dropout_prob": 0.0,
                   "norm_layers": [], "latent_in": [1], "weight_norm": True},
    encoder_name="di_encoder",
    encoder_specs={"per_point_feat": [6, 8, 16], "bn": {"class": "BatchNorm"}},
    training_loss={"types": ["neg_log_likelihood", "reg_loss"], "enforce_minmax": True,
                   "clamping_distance": 0.2, "code_reg_lambda": 1e-2})
# the same with weight norm on every layer (the shipped prior's layout)
TINY_WN = dict(TINY, network_specs=dict(TINY["network_specs"], norm_layers=[0, 1, 2]))


def _capture(learning_rate):
    """An optax transformation that keeps the gradient as its state and
    leaves the parameters: JAX's own train step then hands back its grads."""
    del learning_rate
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


def _jax_setup(cfg, opts):
    args = jdict_to_args(cfg)
    model = jio.build_model(args, seed=0)
    enc_cfg = JEncoderConfig(args.code_length, model.encoder_config.dims[:-1],
                             bn=args.encoder_specs.get("bn"), mode="train")
    loss_args = jdict_to_args(args.training_loss)
    step = make_train_step(model.decoder_config, enc_cfg, loss_args.types, loss_args,
                           S, 1, *opts)
    state = [model.decoder_params, model.encoder_params, model.encoder_bn,
             opts[0].init(model.decoder_params), opts[1].init(model.encoder_params)]
    # numpy copies: the JAX step donates (deletes) its input arrays
    weights = jax.tree_util.tree_map(np.array, state[:3])
    return weights, step, state


def _port_step(cfg, weights):
    args = dict_to_args(cfg)
    model = io.build_model(args, seed=1)
    dec, enc = io.train_params_from_jax(*weights)
    model.decoder.load_state_dict(dec)
    model.encoder.load_state_dict(enc)
    return model, TrainStep(model, dict_to_args(args.training_loss), S, 1,
                            torch.Generator().manual_seed(0))


def _run_jax(step, state, sdf, surf, n):
    for _ in range(n):
        *state, logs, _ = step(*state, jnp.asarray(sdf), jnp.asarray(surf),
                               jax.random.PRNGKey(7), jnp.asarray(1), 1e-3, 1e-3)
    return state, logs


@pytest.mark.parametrize("cfg", [TINY, TINY_WN], ids=["plain", "weight_norm"])
def test_one_step_loss_and_grads_match_jax(cfg):
    opts = tuple(optax.inject_hyperparams(_capture)(learning_rate=1e-3) for _ in range(2))
    weights, jstep, state = _jax_setup(cfg, opts)
    sdf, surf = make_batch()
    (dp, ep, bn, dopt, eopt), jlogs = _run_jax(jstep, state, sdf, surf, 1)
    model, step = _port_step(cfg, weights)
    logs = step.loss_and_grads(torch.as_tensor(sdf), torch.as_tensor(surf), 1)
    assert sorted(logs) == sorted(jlogs) == ["ll", "reg", "validation"]
    for k in jlogs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=1e-5, atol=1e-7)
    total_j = float(jlogs["ll"]) + float(jlogs["reg"])
    np.testing.assert_allclose((logs["ll"] + logs["reg"]).item(), total_j, rtol=1e-5)
    jgrads = {"decoder": jax.tree_util.tree_map(np.asarray, dopt.inner_state),
              "encoder": jax.tree_util.tree_map(np.asarray, eopt.inner_state)}
    for part, module in (("decoder", model.decoder), ("encoder", model.encoder)):
        for name, p in module.named_parameters():
            layer, key = name.split(".")
            g = jgrads[part][layer][key]
            scale = max(np.abs(g).max(), 1e-6)
            assert np.abs(p.grad.numpy() - g).max() <= 1e-5 * scale, (part, name)
    # the BN running statistics after the step
    _, port_bn = model.encoder.tree()
    for name, s in jax.tree_util.tree_map(np.asarray, bn).items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(port_bn[name][k], s[k], rtol=1e-5, atol=1e-6)


def test_three_adam_steps_match_jax():
    """optax's Adam and torch.optim.Adam: one formula, another rounding.
    Three steps at lr 1e-3 on the same batch stay within 1e-4."""
    weights, jstep, state = _jax_setup(TINY_WN, make_optimizers())
    sdf, surf = make_batch()
    (dp, ep, bn, _, _), _ = _run_jax(jstep, state, sdf, surf, 3)
    model, step = _port_step(TINY_WN, weights)
    for _ in range(3):
        step.set_lr(1e-3, 1e-3)
        step(torch.as_tensor(sdf), torch.as_tensor(surf), 1)
    tree = model.decoder.tree()
    for name, p in jax.tree_util.tree_map(np.asarray, dp).items():
        for k, v in p.items():
            np.testing.assert_allclose(tree[name][k], v, rtol=0, atol=1e-4)
    params, port_bn = model.encoder.tree()
    for name, p in jax.tree_util.tree_map(np.asarray, ep).items():
        for k, v in p.items():
            np.testing.assert_allclose(params[name][k], v, rtol=0, atol=1e-4)
    for name, s in jax.tree_util.tree_map(np.asarray, bn).items():
        for k, v in s.items():
            np.testing.assert_allclose(port_bn[name][k], v, rtol=1e-4, atol=1e-4)


def test_batch_split_accumulates_the_same_gradient():
    weights, _, _ = _jax_setup(TINY_WN, make_optimizers())
    sdf, surf = make_batch()
    grads = []
    for split in (1, 4):
        model, step = _port_step(TINY_WN, weights)
        step.batch_split = split
        logs = step.loss_and_grads(torch.as_tensor(sdf), torch.as_tensor(surf), 1)
        grads.append(([p.grad.clone() for p in model.decoder.parameters()]
                      + [p.grad.clone() for p in model.encoder.parameters()], logs["ll"]))
    for a, b in zip(grads[0][0], grads[1][0]):
        assert (a - b).abs().max() <= 1e-5 * max(a.abs().max().item(), 1e-6)
    assert abs(grads[0][1].item() - grads[1][1].item()) <= 1e-5 * abs(grads[0][1].item())


@pytest.fixture(scope="module")
def lif_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("trainlif") / "ds"
    data_generator.main([str(REPO / "configs/data-simple.yaml"), "--exec",
                         f"provider_kwargs['n_shapes']=2;sampler_count=30000;output='{out}'"])
    return out


def _train_args(lif_dir, save_dir, run, **kw):
    cfg = dict(
        run_name=run, num_epochs=2, batch_size=4, batch_split=1, samples_per_lif=128,
        min_context_points=16,
        lr_schedule=[{"Type": "Step", "Initial": 1e-3, "Interval": 80, "Factor": 0.4}] * 2,
        train_set=[{"data_path": str(lif_dir), "augment_rotation": "Y",
                    "num_surface_sample": 32, "augment_noise": [0.025, 40.0]}],
        code_bound=None, code_length=29, network_name="di_decoder",
        network_specs={"dims": [64, 64], "dropout": [0, 1, 2], "dropout_prob": 0.2,
                       "norm_layers": [0, 1, 2], "latent_in": [1], "weight_norm": True},
        encoder_name="di_encoder",
        encoder_specs={"per_point_feat": [6, 16, 32], "bn": {"class": "BatchNorm"}},
        snapshot_frequency=2, additional_snapshots=[],
        training_loss={"types": ["neg_log_likelihood", "reg_loss"], "enforce_minmax": True,
                       "clamping_distance": 0.2, "code_reg_lambda": 1e-2},
        save_dir=str(save_dir))
    cfg.update(kw)
    return dict_to_args(cfg)


def _states(model):
    return list(model.decoder.state_dict().values()) + list(model.encoder.state_dict().values())


@pytest.mark.parametrize("device_data", [False, True], ids=["host", "device"])
def test_steps_per_call_equals_single_steps(lif_dir, tmp_path, device_data):
    """K steps back to back with one read of their mean: the same batches,
    dropout draws and parameters as single steps, over truncated epochs."""
    m1, d1 = train(_train_args(lif_dir, tmp_path, "spc1", device_data=device_data,
                               steps_per_call=1), max_steps_per_epoch=5, device="cpu")
    m3, d3 = train(_train_args(lif_dir, tmp_path, "spc3", device_data=device_data,
                               steps_per_call=3), max_steps_per_epoch=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_states(m1), _states(m3)))
    recs = [json.loads(l) for l in (d3 / "logs" / "scalars.jsonl").read_text().splitlines()]
    # 5 steps an epoch as calls of 3 + 2: one record per call
    assert [r["step"] for r in recs if r["tag"] == "train/ll"] == [3, 5, 8, 10]


def test_resume_continues(lif_dir, tmp_path):
    m2, d = train(_train_args(lif_dir, tmp_path, "r"), max_steps_per_epoch=4, device="cpu")
    assert (d / "optimizer_2.pt").exists() and (d / "model_2.npz").exists()
    runs = []
    for _ in range(2):
        m4, _ = train(_train_args(lif_dir, tmp_path, "r", num_epochs=4), max_steps_per_epoch=4,
                      resume_epoch=2, device="cpu")
        runs.append(m4)
    assert (d / "model_4.npz").exists()
    # resuming is repeatable, starts from the snapshot and keeps Adam's state
    assert all(torch.equal(a, b) for a, b in zip(_states(runs[0]), _states(runs[1])))
    p2 = jio.load_params(d / "model_2.npz")
    p4 = jio.load_params(d / "model_4.npz")
    drift = float(np.abs(np.asarray(p4["lin0"]["v"]) - np.asarray(p2["lin0"]["v"])).mean())
    assert 0 < drift < 0.05
    opt = torch.load(d / "optimizer_4.pt")
    assert all(float(s["step"]) == 16 for s in opt["decoder"]["state"].values())


def test_entries_train_and_loss_falls(lif_dir, tmp_path):
    """network_trainer on the shipped configuration's widths, on the CPU:
    the loss falls over two short epochs and JAX loads the snapshot."""
    ex = (f"train_set[0]['data_path']='{lif_dir}';save_dir='{tmp_path}';run_name='e';"
          "max_steps_per_epoch=6;batch_size=4;samples_per_lif=256;additional_snapshots=[2]")
    save = network_trainer.main([str(REPO / "configs/train-cnp.yaml"), "--device", "cpu",
                                 "--num_epochs", "2", "--exec", ex])
    recs = [json.loads(l) for l in (save / "logs" / "scalars.jsonl").read_text().splitlines()]
    lls = [r["train"] for r in recs if r["tag"] == "epoch_sum/ll"]
    assert len(lls) == 2 and lls[1] < lls[0]
    assert all(np.isfinite(r.get("scalar", r.get("train"))) for r in recs)
    jm, _ = jio.load_model(save / "hyper.json", 2)
    tm, _ = io.load_model(save / "hyper.json", 2)
    x = np.random.RandomState(0).randn(200, 32).astype(np.float32) * 0.4
    sdf_j, _ = apply_decoder(jm.decoder_params, jm.decoder_config, jnp.asarray(x))
    np.testing.assert_allclose(tm.decoder(torch.as_tensor(x))[0].numpy(), np.asarray(sdf_j),
                               atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        network_trainer.main([str(REPO / "configs/train-cnp.yaml"), "--dp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            network_trainer.main([str(REPO / "configs/train-cnp.yaml"), "--exec", ex])
