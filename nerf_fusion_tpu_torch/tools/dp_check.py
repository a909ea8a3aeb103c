"""Data-parallel training against one process on one fixed global batch.

    python -m nerf_fusion_tpu_torch.tools.dp_check [--dp N] [--device cuda|cpu]
        [--steps 2] [--out FILE.npz]

The tiny training step (latent 8, decoder 16-16 with weight norm, encoder
6-8-16 with BatchNorm, no dropout; 8 LIFs x 32 SDF samples and 16 surface
points) from seeded weights, on a global batch whose halves come from
different distributions (so that per-rank BatchNorm statistics would
differ from the whole batch's): ``--steps`` Adam steps in this process,
then in ``--dp`` processes (``parallel.launch``), each on its slice of the
same batch.  Then the encoder alone with a point mask (which the trainer
does not use): its pooled output, the input gradient of the output's sum
of squares and the running statistics, the ranks' slices gathered.
Prints the largest differences and exits non-zero beyond the JAX
package's bar for its own data parallelism (losses within 5e-3 relative,
parameters, and here the masked encoder's outputs, within 5e-4;
``tests/test_multichip.py``).  ``--out`` keeps the initial weights, the
batch and both results.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import parallel
from ..main import resolve_device
from ..models import io
from ..models.encoder import EncoderConfig, TrainEncoder
from ..trainer.train import TrainStep
from ..utils.config import dict_to_args

B, S, M = 8, 32, 16
TINY = dict(
    code_length=8, code_bound=None, network_name="di_decoder",
    network_specs={"dims": [16, 16], "dropout": [], "dropout_prob": 0.0,
                   "norm_layers": [], "latent_in": [1], "weight_norm": True},
    encoder_name="di_encoder",
    encoder_specs={"per_point_feat": [6, 8, 16], "bn": {"class": "BatchNorm"}},
    training_loss={"types": ["neg_log_likelihood", "reg_loss"], "enforce_minmax": True,
                   "clamping_distance": 0.2, "code_reg_lambda": 1e-2})
TOL_LOSS = 5e-3     # relative
TOL_PARAM = 5e-4


def make_batch(seed: int = 0):
    """(sdf (B, S, 4), surface (B, M, 6)): the second half of the LIFs
    shifted and scaled away from the first."""
    rng = np.random.RandomState(seed)
    sdf = ((rng.rand(B, S, 4) - 0.5) * 0.4).astype(np.float32)
    surf = np.concatenate([(rng.rand(B, M, 3) - 0.5) * 0.6, rng.randn(B, M, 3)],
                          axis=-1).astype(np.float32)
    surf[..., 3:6] /= np.linalg.norm(surf[..., 3:6], axis=-1, keepdims=True)
    sdf[B // 2:, :, :3] = sdf[B // 2:, :, :3] * 2.5 + 0.3
    surf[B // 2:, :, :3] = surf[B // 2:, :, :3] * 3.0 + 0.5
    return sdf, surf


def init_weights(seed: int = 0) -> dict:
    """The tiny networks' weights as the JAX package's pytrees."""
    model = io.build_model(dict_to_args(TINY), seed=seed)
    params, bn = model.encoder.tree()
    return {"dec": model.decoder.tree(), "enc": params, "bn": bn}


def run_steps(device, weights: dict, sdf, surf, n_steps: int, dp: bool):
    """``n_steps`` steps from ``weights``; under ``dp`` on this rank's slice.
    :return: (the last step's losses, the weights after)."""
    model = io.build_model(dict_to_args(TINY))
    dec, enc = io.train_params_from_jax(weights["dec"], weights["enc"], weights["bn"])
    model.decoder.load_state_dict(dec)
    model.encoder.load_state_dict(enc)
    model.to(device)
    rank, world = parallel.world() if dp else (0, 1)
    sdf, surf = (torch.as_tensor(x).to(device) for x in parallel.shard((sdf, surf), rank, world))
    step = TrainStep(model, dict_to_args(TINY["training_loss"]), S, 1,
                     torch.Generator(device=device).manual_seed(7), ddp=dp)
    for _ in range(n_steps):
        step.set_lr(1e-3, 1e-3)
        logs = step(sdf, surf, 1)
    params, bn = model.encoder.tree()
    return ({k: float(v) for k, v in logs.items()},
            {"dec": model.decoder.tree(), "enc": params, "bn": bn})


def point_mask(seed: int = 1) -> np.ndarray:
    """(B, M) bool, about 70 % of the points, at least one a LIF."""
    mask = np.random.RandomState(seed).rand(B, M) < 0.7
    mask[:, 0] = True
    return mask


def masked_encoder(device, weights: dict, surf, mask, dp: bool) -> dict:
    """The training encoder (mean-pooled) on ``surf`` with ``mask``, under
    ``dp`` on this rank's slice with its BatchNorm statistics synchronised:
    the output, the input gradient of the output's sum of squares (summed
    over the ranks) and the running statistics after."""
    cfg = EncoderConfig(TINY["code_length"], TINY["encoder_specs"]["per_point_feat"],
                        bn=TINY["encoder_specs"]["bn"], mode="train")
    enc = TrainEncoder(cfg, weights["enc"], weights["bn"]).to(device)
    enc.sync_stats = dp
    rank, world = parallel.world() if dp else (0, 1)
    x, m = (torch.as_tensor(a).to(device) for a in parallel.shard((surf, mask), rank, world))
    x.requires_grad_()
    out = enc(x, m)
    (out ** 2).sum().backward()
    res = {"out": out.detach(), "grad": x.grad}
    if dp and world > 1:
        res = {k: torch.cat(_gather(v)) for k, v in res.items()}
    return {**{k: v.cpu().numpy() for k, v in res.items()}, "bn": enc.tree()[1]}


def _gather(t: torch.Tensor) -> list:
    parts = [torch.empty_like(t) for _ in range(parallel.world()[1])]
    torch.distributed.all_gather(parts, t.contiguous())
    return parts


def _rank(device, weights, sdf, surf, n_steps, out):
    losses, after = run_steps(device, weights, sdf, surf, n_steps, dp=True)
    masked = masked_encoder(device, weights, surf, point_mask(), dp=True)
    if parallel.world()[0] == 0:
        io.save_params(out, {"loss": losses, **after, "masked": masked})


def compare(a: dict, b: dict) -> tuple:
    """(largest relative loss difference, largest difference of the rest:
    parameters, and the masked encoder's results where both hold them)."""
    fa, fb = io.flatten(a), io.flatten(b)
    fa = {k: v for k, v in fa.items() if k in fb}
    loss = max(abs(float(fa[k]) - float(fb[k])) / max(1.0, abs(float(fb[k])))
               for k in fa if k.startswith("loss/"))
    param = max(float(np.abs(fa[k] - fb[k]).max()) for k in fa if not k.startswith("loss/"))
    return loss, param


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    weights = init_weights()
    sdf, surf = make_batch()
    losses, single = run_steps(device, weights, sdf, surf, a.steps, dp=False)
    single = {"loss": losses, **single,
              "masked": masked_encoder(device, weights, surf, point_mask(), dp=False)}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.npz"
        parallel.launch(_rank, a.dp, device, (weights, sdf, surf, a.steps, out))
        ranked = io.load_params(out)
    loss_err, param_err = compare(ranked, single)
    print(f"dp_check: {a.dp} ranks ({parallel.backend(device)}) against one process, "
          f"{a.steps} steps: losses {single['loss']} vs "
          f"{ {k: float(v) for k, v in ranked['loss'].items()} }, max rel loss diff "
          f"{loss_err:.3e} (bar {TOL_LOSS}), max param diff {param_err:.3e} (bar {TOL_PARAM})",
          flush=True)
    if a.out:
        io.save_params(a.out, {"init": weights, "batch": {"sdf": sdf, "surf": surf},
                               "single": single, "dp": ranked})
    res = dict(loss_err=loss_err, param_err=param_err, ok=loss_err <= TOL_LOSS
               and param_err <= TOL_PARAM)
    if not res["ok"]:
        sys.exit(f"dp_check: data-parallel run differs from one process beyond the bar: {res}")
    return res


if __name__ == "__main__":
    main()
