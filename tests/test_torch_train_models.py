"""The port's training modules and checkpoints against the JAX package.

The same numpy weights and inputs go through the JAX training forwards
(``apply_decoder(train=True)``, ``apply_encoder(train=True)``) and the
port's ``TrainDecoder`` / ``TrainEncoder``; checkpoints written by one
package are read by the other.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models import io as jio
from nerf_fusion_tpu.models.decoder import DecoderConfig as JDecoderConfig
from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.decoder import decoder_param_count as jax_param_count
from nerf_fusion_tpu.models.decoder import init_decoder as jax_init_decoder
from nerf_fusion_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nerf_fusion_tpu.models.encoder import apply_encoder
from nerf_fusion_tpu.models.encoder import init_encoder as jax_init_encoder
from nerf_fusion_tpu_torch.models import io
from nerf_fusion_tpu_torch.models.decoder import (Decoder, DecoderConfig, decoder_param_count,
                                                  dropout, init_decoder)
from nerf_fusion_tpu_torch.models.encoder import Encoder, EncoderConfig, init_encoder
from nerf_fusion_tpu_torch.utils.config import dict_to_args

REPO = Path(__file__).resolve().parent.parent
# f32 on both sides on the CPU; only the products' summation order differs
TOL = 1e-5

SHIPPED_DEC = dict(dims=[128, 128, 128, 128], dropout=[0, 1, 2, 3, 4, 5], dropout_prob=0.2,
                   norm_layers=[0, 1, 2, 3, 4, 5], latent_in=[3], weight_norm=True)
# a small architecture with plain layers, weight-norm layers and a re-fed input
SMALL_DEC = dict(dims=[16, 24, 16], dropout=[0, 1], dropout_prob=0.0,
                 norm_layers=[0, 2], latent_in=[2], weight_norm=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _args(latent, dec_specs, feat):
    return dict_to_args(dict(code_length=latent, network_specs=dec_specs,
                             encoder_specs={"per_point_feat": feat,
                                            "bn": {"class": "BatchNorm"}}))


def _jax_pair(latent, dec_specs, feat, seed=0):
    """JAX params for a decoder and a train-mode encoder (BN state moved off
    its init so eval mode and the running update are exercised)."""
    dcfg = JDecoderConfig(latent, **dec_specs)
    ecfg = JEncoderConfig(latent, feat, bn={"class": "BatchNorm"}, mode="train")
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    dp = _np(jax_init_decoder(k1, dcfg))
    ep, bn = _np(jax_init_encoder(k2, ecfg))
    rng = np.random.RandomState(seed)
    for s in bn.values():
        s["scale"] = (1 + 0.2 * rng.randn(*s["scale"].shape)).astype(np.float32)
        s["bias"] = (0.1 * rng.randn(*s["bias"].shape)).astype(np.float32)
        s["mean"] = (0.1 * rng.randn(*s["mean"].shape)).astype(np.float32)
        s["var"] = (1 + 0.5 * rng.rand(*s["var"].shape)).astype(np.float32)
    return dcfg, dp, ecfg, ep, bn


def _port_pair(latent, dec_specs, feat, dp, ep, bn, mode="train"):
    dec = init_decoder(DecoderConfig(latent, **dec_specs), torch.Generator().manual_seed(0))
    enc = init_encoder(EncoderConfig(latent, feat, bn={"class": "BatchNorm"}, mode=mode),
                       torch.Generator().manual_seed(0))
    dstate, estate = io.train_params_from_jax(dp, ep, bn)
    dec.load_state_dict(dstate)
    enc.load_state_dict(estate)
    return dec, enc


@pytest.mark.parametrize("latent,specs", [(29, SHIPPED_DEC), (8, SMALL_DEC)],
                         ids=["shipped", "small"])
def test_train_decoder_matches_apply_decoder(latent, specs):
    specs_nodrop = dict(specs, dropout_prob=0.0)
    dcfg, dp, _, ep, bn = _jax_pair(latent, specs_nodrop, [6, 8, 16])
    dec, _ = _port_pair(latent, specs_nodrop, [6, 8, 16], dp, ep, bn)
    x = np.random.RandomState(1).randn(700, latent + 3).astype(np.float32) * 0.5
    sdf_j, std_j = apply_decoder(dp, dcfg, jnp.asarray(x), train=True,
                                 rng=jax.random.PRNGKey(0))
    dec.train()
    sdf_t, std_t = dec(torch.as_tensor(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(std_t.detach().numpy(), np.asarray(std_j), rtol=0, atol=TOL)


def test_train_decoder_dropout_draws():
    """Dropout keeps 1 - p of the listed activations, scaled by 1 / (1 - p),
    from the generator it is given (its own stream, not JAX's)."""
    dec = init_decoder(DecoderConfig(29, **SHIPPED_DEC), torch.Generator().manual_seed(0))
    x = torch.randn(4000, 32, generator=torch.Generator().manual_seed(2))
    dec.train()
    a, _ = dec(x, torch.Generator().manual_seed(5))
    b, _ = dec(x, torch.Generator().manual_seed(5))
    c, _ = dec(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        dec(x)
    dec.eval()
    e, _ = dec(x)
    assert not torch.equal(a, e)
    # the keep rate and the scale
    h = torch.rand(200, 500, generator=torch.Generator().manual_seed(9)) + 0.5
    d = dropout(h, 0.2, torch.Generator().manual_seed(3))
    kept = d != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    assert torch.equal(d[kept], h[kept] / 0.8)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_train_encoder_matches_apply_encoder(masked):
    feat = [6, 32, 64, 256]
    _, dp, ecfg, ep, bn = _jax_pair(29, SHIPPED_DEC, feat)
    _, enc = _port_pair(29, SHIPPED_DEC, feat, dp, ep, bn)
    rng = np.random.RandomState(3)
    x = rng.randn(8, 48, 6).astype(np.float32)
    mask = (rng.rand(8, 48) > 0.3) if masked else None
    lat_j, bn_j = apply_encoder(ep, bn, ecfg, jnp.asarray(x), train=True,
                                point_mask=None if mask is None else jnp.asarray(mask))
    enc.train()
    lat_t = enc(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask))
    assert lat_t.shape == (8, 29)
    np.testing.assert_allclose(lat_t.detach().numpy(), np.asarray(lat_j), rtol=0, atol=TOL)
    _, bn_t = enc.tree()
    for name, s in _np(bn_j).items():
        for k in ("mean", "var", "scale", "bias"):
            np.testing.assert_allclose(bn_t[name][k], s[k], rtol=TOL, atol=TOL)
    # eval mode reads the running statistics
    enc.eval()
    lat_e = enc(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask))
    lat_je, _ = apply_encoder(ep, _np(bn_j), ecfg, jnp.asarray(x), train=False,
                              point_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(lat_e.detach().numpy(), np.asarray(lat_je), rtol=0, atol=TOL)


def test_init_shapes_and_param_count():
    args = _args(29, SHIPPED_DEC, [6, 32, 64, 256])
    model = io.build_model(args, seed=0)
    jmodel = jio.build_model(args, seed=0)
    tree = model.decoder.tree()
    jtree = _np(jmodel.decoder_params)
    assert {k: {kk: v.shape for kk, v in p.items()} for k, p in tree.items()} == \
        {k: {kk: v.shape for kk, v in p.items()} for k, p in jtree.items()}
    assert decoder_param_count(model.decoder) == jax_param_count(jmodel.decoder_params)
    params, bn = model.encoder.tree()
    assert {k: {kk: v.shape for kk, v in p.items()} for k, p in params.items()} == \
        {k: {kk: v.shape for kk, v in p.items()} for k, p in _np(jmodel.encoder_params).items()}
    assert sorted(bn) == sorted(jmodel.encoder_bn)
    # g starts at the row norms of v; the weights follow torch's Linear bound
    for layer, in_dim, _ in model.decoder_config.layer_shapes():
        p = tree[f"lin{layer}"]
        np.testing.assert_allclose(p["g"], np.linalg.norm(p["v"], axis=1), rtol=1e-6)
        assert np.abs(p["v"]).max() <= 1 / np.sqrt(in_dim)
    # a seed gives the same weights; another seed others
    again = io.build_model(args, seed=0).decoder.tree()
    other = io.build_model(args, seed=1).decoder.tree()
    assert np.array_equal(again["lin0"]["v"], tree["lin0"]["v"])
    assert not np.array_equal(other["lin0"]["v"], tree["lin0"]["v"])


def test_fold_matches_training_modules_in_eval_mode():
    """The folded eval modules (the kernels' weights) against the training
    modules in eval mode, on the shipped architecture."""
    feat = [6, 32, 64, 256]
    _, dp, _, ep, bn = _jax_pair(29, SHIPPED_DEC, feat)
    dec, enc = _port_pair(29, SHIPPED_DEC, feat, dp, ep, bn, mode="cnp")
    nets = io.Networks(Decoder(dec.fold()), Encoder(enc.fold()))
    dec.eval()
    enc.eval()
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randn(3000, 32).astype(np.float32) * 0.4)
    sdf_e, std_e = nets.decoder(x)
    sdf_t, std_t = dec(x)
    assert (sdf_e - sdf_t).abs().max().item() <= TOL
    assert (std_e - std_t).abs().max().item() <= TOL
    pts = torch.as_tensor(rng.randn(3000, 6).astype(np.float32))
    assert (nets.encoder(pts) - enc(pts)).abs().max().item() <= TOL


def test_port_checkpoint_loads_in_jax(tmp_path):
    """save_checkpoint -> the JAX package's load_params / load_model."""
    args = _args(29, SHIPPED_DEC, [6, 32, 64, 256])
    model = io.build_model(args, seed=3)
    rng = np.random.RandomState(0)
    model.encoder.train()
    model.encoder(torch.as_tensor(rng.randn(4, 32, 6).astype(np.float32)))  # moves BN state
    io.save_checkpoint(tmp_path, 7, model)
    hyper = dict(vars(args), network_name="di_decoder", encoder_name="di_encoder")
    io.write_hyper_json(tmp_path, hyper)
    jm, _ = jio.load_model(tmp_path / "hyper.json", 7)
    x = rng.randn(500, 32).astype(np.float32) * 0.5
    sdf_j, std_j = apply_decoder(jm.decoder_params, jm.decoder_config, jnp.asarray(x))
    model.decoder.eval()
    sdf_t, std_t = model.decoder(torch.as_tensor(x))
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(std_t.detach().numpy(), np.asarray(std_j), atol=TOL, rtol=0)
    pts = rng.randn(300, 6).astype(np.float32)
    lat_j, _ = apply_encoder(jm.encoder_params, jm.encoder_bn, jm.encoder_config,
                             jnp.asarray(pts))
    nets = io.Networks(Decoder(model.decoder.fold()), Encoder(model.encoder.fold()))
    np.testing.assert_allclose(nets.encoder(torch.as_tensor(pts)).numpy(),
                               np.asarray(lat_j), atol=TOL, rtol=0)
    # the port's own eval loader reads the same files
    tm, _ = io.load_model(tmp_path / "hyper.json", 7)
    assert torch.equal(tm.decoder.packed, nets.decoder.packed)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """The JAX package's save_checkpoint -> the port's load_checkpoint, on a
    small architecture that the kernels do not take."""
    args = _args(8, SMALL_DEC, [6, 8, 16])
    jm = jio.build_model(args, seed=5)
    jio.save_checkpoint(tmp_path, 3, jm)
    model = io.load_checkpoint(io.build_model(args, seed=0), tmp_path, 3)
    x = np.random.RandomState(1).randn(400, 11).astype(np.float32)
    model.decoder.eval()
    sdf_t, std_t = model.decoder(torch.as_tensor(x))
    sdf_j, std_j = apply_decoder(jm.decoder_params, jm.decoder_config, jnp.asarray(x))
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(std_t.detach().numpy(), np.asarray(std_j), atol=TOL, rtol=0)
    params, bn = model.encoder.tree()
    for name, p in _np(jm.encoder_params).items():
        for k, v in p.items():
            assert np.array_equal(params[name][k], v)
    for name, s in _np(jm.encoder_bn).items():
        for k, v in s.items():
            assert np.array_equal(bn[name][k], v)
    with pytest.raises(ValueError):
        Decoder(model.decoder.fold())


def test_torch_checkpoint_roundtrip_and_full_trained():
    """import_torch_checkpoint(ckpt/full_trained .pth.tar) equals the npz of
    the same epoch; export -> import is the identity; the JAX importer reads
    the port's export."""
    hyper = REPO / "ckpt/full_trained/hyper.json"
    jm, args = jio.load_model(hyper, 600)          # the npz
    model = io.import_torch_checkpoint(io.build_model(args), REPO / "ckpt/full_trained/model_600.pth.tar",
                                       REPO / "ckpt/full_trained/encoder_600.pth.tar")
    tree = model.decoder.tree()
    for name, p in _np(jm.decoder_params).items():
        for k, v in p.items():
            assert np.array_equal(tree[name][k], v), (name, k)
    params, bn = model.encoder.tree()
    for name, p in _np(jm.encoder_params).items():
        for k, v in p.items():
            assert np.array_equal(params[name][k], v), (name, k)
    for name, s in _np(jm.encoder_bn).items():
        for k, v in s.items():
            assert np.array_equal(bn[name][k], v), (name, k)


def test_torch_checkpoint_export_import(tmp_path):
    args = _args(29, SHIPPED_DEC, [6, 32, 64, 256])
    model = io.build_model(args, seed=2)
    model.encoder.train()
    model.encoder(torch.randn(2, 16, 6, generator=torch.Generator().manual_seed(0)))
    io.export_torch_checkpoint(model, tmp_path / "model.pth.tar", tmp_path / "encoder.pth.tar",
                               epoch=4)
    back = io.import_torch_checkpoint(io.build_model(args, seed=9), tmp_path / "model.pth.tar",
                                      tmp_path / "encoder.pth.tar")
    for a, b in zip(model.decoder.state_dict().values(), back.decoder.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(model.encoder.state_dict().values(), back.encoder.state_dict().values()):
        assert torch.equal(a, b)
    state = torch.load(tmp_path / "model.pth.tar", weights_only=False)
    assert state["epoch"] == 4 and state["model_state"]["lin0.weight_g"].shape == (128, 1)
    jm = jio.build_model(args, seed=0)
    jio.import_torch_checkpoint(jm, tmp_path / "model.pth.tar", tmp_path / "encoder.pth.tar")
    for name, p in model.decoder.tree().items():
        for k, v in p.items():
            assert np.array_equal(np.asarray(jm.decoder_params[name][k]), v)
