"""Model container and checkpoint loading.

``load_model`` reads the frozen ``hyper.json`` beside the per-epoch
checkpoints ``model_<ep>.npz`` (decoder) and ``encoder_<ep>.npz`` (encoder
params + BatchNorm state), flat-keyed ``a/b/c`` arrays as the JAX package
writes them.  ``params_from_jax`` builds the same modules from the JAX
package's parameter pytrees handed over as numpy arrays, so both
packages can compute with identical weights.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops import mlp
from ..utils.config import parse_config_json
from .decoder import Decoder
from .encoder import Encoder


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


def load_params(path) -> dict:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


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
