"""Model containers, checkpoints and their conversions.

``load_model`` reads the frozen ``hyper.json`` beside the per-epoch
checkpoints ``model_<ep>.npz`` (decoder) and ``encoder_<ep>.npz`` (encoder
params + BatchNorm state), flat-keyed ``a/b/c`` arrays as the JAX package
writes them, and folds them into the eval modules that the kernels run
(the shipped architecture only).  ``params_from_jax`` builds the same
modules from the JAX package's parameter pytrees handed over as numpy
arrays, so both packages can compute with identical weights.

The training side takes any architecture: ``build_model`` makes the
training modules from a hyper config, ``save_checkpoint`` writes them in
the JAX layout (``model_<e>.npz`` with ``lin{i}/{v,g,b}`` and
``unc/{w,b}``; ``encoder_<e>.npz`` with ``params/...`` and ``bn/...``), so
each package loads the other's checkpoints, and ``load_checkpoint`` reads
them back.  ``export_torch_checkpoint`` / ``import_torch_checkpoint``
convert to and from the reference's ``.pth.tar`` layout (weight-norm
``weight_v`` / ``weight_g``, 1x1 convolutions, BN running statistics).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..ops import mlp
from ..utils.config import parse_config_json
from .decoder import Decoder, DecoderConfig, TrainDecoder, init_decoder
from .encoder import Encoder, EncoderConfig, TrainEncoder, init_encoder


class Networks:
    """The decoder and encoder modules."""

    def __init__(self, decoder: Decoder, encoder: Encoder):
        self.decoder = decoder
        self.encoder = encoder

    def to(self, device):
        self.decoder.to(device)
        self.encoder.to(device)
        return self


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def load_params(path) -> dict:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def save_params(path, tree: dict):
    np.savez(path, **flatten(tree))


def params_from_jax(decoder_params: dict, encoder_params: dict,
                    encoder_bn: dict) -> Networks:
    """Modules from the JAX pytrees (numpy leaves): weight-norm and eval
    BatchNorm folded exactly as the fused TPU kernels fold them."""
    n_enc = len(encoder_params)
    dec = Decoder(mlp.fold_decoder_weights(decoder_params))
    enc = Encoder(mlp.fold_encoder_weights(
        encoder_params, encoder_bn, n_enc, lambda i: f"layer{i}" in encoder_bn))
    return Networks(dec, enc)


def load_model(training_hyper_path, use_epoch: int = -1):
    """hyper.json + epoch checkpoint -> (Networks on the CPU, hyper args).

    The modules check the checkpoint's shapes against the kernels' fixed
    architecture (latent 29, hidden 128, encoder 6-32-64-256-29)."""
    training_hyper_path = Path(training_hyper_path)
    if not training_hyper_path.name.endswith("json"):
        raise ValueError("load_model expects a frozen hyper.json")
    args = parse_config_json(training_hyper_path)
    exp_dir = training_hyper_path.parent
    epochs = sorted(int(p.name[len("model_"):-len(".npz")])
                    for p in exp_dir.glob("model_*.npz"))
    if use_epoch == -1 and epochs:
        use_epoch = epochs[-1]
    if use_epoch not in epochs:
        raise FileNotFoundError(
            f"no model_{use_epoch}.npz under {exp_dir} (found epochs {epochs})")
    if list(args.network_specs.get("latent_in", [])) != [3]:
        raise ValueError("decoder kernel supports only latent_in [3]")
    enc = load_params(exp_dir / f"encoder_{use_epoch}.npz")
    model = params_from_jax(load_params(exp_dir / f"model_{use_epoch}.npz"),
                            enc["params"], enc.get("bn", {}))
    return model, args


class TrainNetworks:
    """The training modules and their configs."""

    def __init__(self, decoder: TrainDecoder, encoder: TrainEncoder):
        self.decoder_config = decoder.config
        self.encoder_config = encoder.config
        self.decoder = decoder
        self.encoder = encoder

    def to(self, device):
        self.decoder.to(device)
        self.encoder.to(device)
        return self


def build_model(args, seed: int = 0) -> TrainNetworks:
    """Training modules from a hyper config (``code_length``,
    ``network_specs``, ``encoder_specs``), weights drawn from ``seed``, on
    the CPU.  The encoder mean-pools (``mode="train"``)."""
    gen = torch.Generator().manual_seed(seed)
    dec = init_decoder(DecoderConfig(args.code_length, **args.network_specs), gen)
    enc_specs = dict(args.encoder_specs)
    enc = init_encoder(EncoderConfig(args.code_length, enc_specs["per_point_feat"],
                                     bn=enc_specs.get("bn"), mode="train"), gen)
    return TrainNetworks(dec, enc)


def train_params_from_jax(decoder_params: dict, encoder_params: dict,
                          encoder_bn: dict):
    """The JAX package's pytrees (numpy leaves) -> (decoder state dict,
    encoder state dict) of the training modules."""
    t = lambda v: torch.from_numpy(np.array(v, dtype=np.float32))
    dec = {f"{name}.{k}": t(v) for name, p in decoder_params.items() for k, v in p.items()}
    enc = {f"{name}.{k}": t(v) for name, p in encoder_params.items() for k, v in p.items()}
    enc.update({f"{name}.{k}": t(v) for name, s in encoder_bn.items() for k, v in s.items()})
    return dec, enc


def _load_trees(model: TrainNetworks, decoder_params, encoder_params, encoder_bn):
    dec, enc = train_params_from_jax(decoder_params, encoder_params, encoder_bn)
    model.decoder.load_state_dict(dec)
    model.encoder.load_state_dict(enc)
    return model


def save_checkpoint(save_dir, epoch: int, model: TrainNetworks, extra: dict = None):
    save_dir = Path(save_dir)
    save_params(save_dir / f"model_{epoch}.npz", model.decoder.tree())
    params, bn = model.encoder.tree()
    save_params(save_dir / f"encoder_{epoch}.npz", {"params": params, "bn": bn})
    if extra is not None:
        save_params(save_dir / f"training_{epoch}.npz", extra)


def load_checkpoint(model: TrainNetworks, save_dir, epoch: int) -> TrainNetworks:
    """``model_<epoch>.npz`` and ``encoder_<epoch>.npz`` (either package's)
    into the training modules."""
    save_dir = Path(save_dir)
    enc = load_params(save_dir / f"encoder_{epoch}.npz")
    return _load_trees(model, load_params(save_dir / f"model_{epoch}.npz"),
                       enc["params"], enc.get("bn", {}))


def _dotted(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


def mlp_from_jax(params: dict, dims, bn: bool = False, shared: bool = False,
                 last_act: bool = False):
    """The JAX ``init_mlp`` / ``init_shared_mlp`` pytree (numpy leaves) as a
    ``zoo.MLP`` (``SharedMLP`` with ``shared``)."""
    from .zoo import MLP, SharedMLP

    net = (SharedMLP if shared else MLP)(dims, bn=bn, last_act=last_act)
    net.load_state_dict(_dotted(params))
    return net


def _resnet_state(params: dict) -> dict:
    """The JAX backbone pytree's keys as torchvision's."""
    bn = lambda p, pre: {f"{pre}.weight": p["scale"], f"{pre}.bias": p["bias"],
                         f"{pre}.running_mean": p["mean"], f"{pre}.running_var": p["var"]}
    sd = {"conv1.weight": params["conv1"]["w"], **bn(params["bn1"], "bn1")}
    for name, blk in params.items():
        if not name.startswith("layer"):
            continue
        sd[f"{name}.conv1.weight"] = blk["conv1"]["w"]
        sd[f"{name}.conv2.weight"] = blk["conv2"]["w"]
        sd.update(bn(blk["bn1"], f"{name}.bn1"))
        sd.update(bn(blk["bn2"], f"{name}.bn2"))
        if "down_conv" in blk:
            sd[f"{name}.downsample.0.weight"] = blk["down_conv"]["w"]
            sd.update(bn(blk["down_bn"], f"{name}.downsample.1"))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def img_encoder_from_jax(enc_type: str, params: dict, **kwargs):
    """The JAX image encoder of ``enc_type`` (spatial, global, conv, resnet;
    its config from ``kwargs``) with the pytree's weights (numpy leaves)."""
    from .img_encoder import make_encoder

    net = make_encoder(enc_type, **kwargs)
    net.load_state_dict(_resnet_state(params) if enc_type == "resnet" else _dotted(params))
    return net


def write_hyper_json(save_dir, args):
    def _default(o):
        if isinstance(o, Path):
            return str(o)
        return repr(o)
    with (Path(save_dir) / "hyper.json").open("w") as f:
        json.dump(vars(args) if not isinstance(args, dict) else args, f,
                  indent=2, default=_default)


def export_torch_checkpoint(model: TrainNetworks, decoder_path, encoder_path=None,
                            epoch: int = 0):
    """The training modules as reference-layout ``.pth.tar`` files
    (``lin{i}.weight_v`` / ``weight_g`` (out, 1) / ``bias``,
    ``uncertainty_layer``, ``mlp.layer{i}.conv.weight`` (out, in, 1) and
    ``normlayer.bn.*``)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    dstate = {}
    tree = model.decoder.tree()
    for layer in range(model.decoder_config.num_layers - 1):
        p = tree[f"lin{layer}"]
        if "v" in p:
            dstate[f"lin{layer}.weight_v"] = t(p["v"])
            dstate[f"lin{layer}.weight_g"] = t(p["g"]).reshape(-1, 1)
        else:
            dstate[f"lin{layer}.weight"] = t(p["w"])
        dstate[f"lin{layer}.bias"] = t(p["b"])
    dstate["uncertainty_layer.weight"] = t(tree["unc"]["w"])
    dstate["uncertainty_layer.bias"] = t(tree["unc"]["b"])
    torch.save({"epoch": epoch, "model_state": dstate}, decoder_path)

    if encoder_path is not None:
        params, bn = model.encoder.tree()
        estate = {}
        for i in range(model.encoder_config.n_layers):
            p = params[f"layer{i}"]
            estate[f"mlp.layer{i}.conv.weight"] = t(p["w"]).unsqueeze(-1)
            if "b" in p:
                estate[f"mlp.layer{i}.conv.bias"] = t(p["b"])
            if f"layer{i}" in bn:
                s = bn[f"layer{i}"]
                pre = f"mlp.layer{i}.normlayer.bn."
                estate[pre + "weight"] = t(s["scale"])
                estate[pre + "bias"] = t(s["bias"])
                estate[pre + "running_mean"] = t(s["mean"])
                estate[pre + "running_var"] = t(s["var"])
                estate[pre + "num_batches_tracked"] = torch.tensor(0)
        torch.save({"epoch": epoch, "model_state": estate}, encoder_path)


def import_torch_checkpoint(model: TrainNetworks, decoder_path, encoder_path=None):
    """Reference-layout ``.pth.tar`` weights into the training modules."""
    dstate = torch.load(decoder_path, map_location="cpu", weights_only=False)["model_state"]
    n = lambda x: x.numpy()
    dparams = {}
    for layer in range(model.decoder_config.num_layers - 1):
        if f"lin{layer}.weight_v" in dstate:
            dparams[f"lin{layer}"] = {"v": n(dstate[f"lin{layer}.weight_v"]),
                                      "g": n(dstate[f"lin{layer}.weight_g"]).reshape(-1),
                                      "b": n(dstate[f"lin{layer}.bias"])}
        else:
            dparams[f"lin{layer}"] = {"w": n(dstate[f"lin{layer}.weight"]),
                                      "b": n(dstate[f"lin{layer}.bias"])}
    dparams["unc"] = {"w": n(dstate["uncertainty_layer.weight"]),
                      "b": n(dstate["uncertainty_layer.bias"])}
    eparams, ebn = model.encoder.tree()
    if encoder_path is not None and Path(encoder_path).exists():
        estate = torch.load(encoder_path, map_location="cpu", weights_only=False)["model_state"]
        eparams, ebn = {}, {}
        for i in range(model.encoder_config.n_layers):
            eparams[f"layer{i}"] = {"w": n(estate[f"mlp.layer{i}.conv.weight"])[:, :, 0]}
            if f"mlp.layer{i}.conv.bias" in estate:
                eparams[f"layer{i}"]["b"] = n(estate[f"mlp.layer{i}.conv.bias"])
            pre = f"mlp.layer{i}.normlayer.bn."
            if pre + "weight" in estate:
                ebn[f"layer{i}"] = {"scale": n(estate[pre + "weight"]),
                                    "bias": n(estate[pre + "bias"]),
                                    "mean": n(estate[pre + "running_mean"]),
                                    "var": n(estate[pre + "running_var"])}
    return _load_trees(model, dparams, eparams, ebn)
