"""The decoder's ``tp`` layout in ``--tp`` ranks against one process.

    python -m nerf_fusion_tpu_torch.tools.tp_check [--tp 2] [--device cuda|cpu]
        [--rows 256] [--out FILE.npz]

Loads the decoder of ``ckpt/default`` (latent 29, hidden 128, weight norm),
runs its eval forward on ``--rows`` seeded inputs in this process, then
split over ``--tp`` ranks (``parallel.tp``: NCCL on ``cuda:<rank>``, gloo
on the CPU), each rank holding its rows of the split tensors and gathering
the split layers' outputs.  Prints the largest difference and exits
non-zero above 1e-5.  ``--out`` keeps the inputs, both outputs and the
names and shard shapes of the split tensors.  On the card it needs
``--tp`` devices.
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
from ..models.decoder import DecoderConfig, TrainDecoder
from ..parallel import tp as tpl
from ..utils.config import parse_config_json

CKPT = Path(__file__).resolve().parents[2] / "ckpt" / "default"
TOL = 1e-5


def load_decoder(ckpt_dir=CKPT, epoch: int = 300):
    """(DecoderConfig, the decoder's pytree of numpy arrays) of a checkpoint."""
    args = parse_config_json(Path(ckpt_dir) / "hyper.json")
    config = DecoderConfig(args.code_length, **args.network_specs)
    return config, io.load_params(Path(ckpt_dir) / f"model_{epoch}.npz")


def make_inputs(rows: int, seed: int = 0) -> np.ndarray:
    """(rows, 32) f32: latents about N(0, 0.1), voxel-local xyz in [-0.5, 0.5]."""
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(rows, 29) * 0.1, rng.rand(rows, 3) - 0.5],
                          axis=1).astype(np.float32)


def forward_whole(device, config, tree, x):
    dec = TrainDecoder(config, tree).to(device).eval()
    with torch.no_grad():
        sdf, std = dec(torch.as_tensor(x, device=device))
    return sdf.cpu().numpy(), std.cpu().numpy()


def _rank(device, config, tree, x, out):
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = parallel.world()
    shard, split = tpl.shard_decoder_params(tree, rank, world)
    shard = {k: {n: v.to(device) for n, v in p.items()} for k, p in shard.items()}
    with torch.no_grad():
        sdf, std = tpl.apply_decoder_tp(shard, split, config, torch.as_tensor(x, device=device),
                                        world)
    if rank == 0:
        io.save_params(out, {
            "sdf": sdf.cpu().numpy(), "std": std.cpu().numpy(),
            "split": {f"{k}/{n}": np.asarray(tuple(shard[k][n].shape))
                      for k in split for n in split[k] if split[k][n]}})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(a.device)
    config, tree = load_decoder()
    x = make_inputs(a.rows)
    sdf, std = forward_whole(device, config, tree, x)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.npz"
        parallel.launch(_rank, a.tp, device, (config, tree, x, out))
        ranked = io.load_params(out)
    err = max(float(np.abs(ranked["sdf"] - sdf).max()), float(np.abs(ranked["std"] - std).max()))
    split = {k.replace("/", "."): tuple(int(d) for d in v)
             for k, v in io.flatten(ranked.get("split", {})).items()}
    print(f"tp_check: {a.tp} ranks ({parallel.backend(device)}) against one process, "
          f"{a.rows} rows: max abs diff {err:.3e} (bar {TOL}); split tensors and their "
          f"shards {split}", flush=True)
    if a.out:
        io.save_params(a.out, {"x": x, "whole": {"sdf": sdf, "std": std}, "tp": ranked})
    res = dict(err=err, split=split, ok=err <= TOL)
    if not res["ok"]:
        sys.exit(f"tp_check: the sharded forward differs from one process beyond {TOL}: {res}")
    return res


if __name__ == "__main__":
    main()
