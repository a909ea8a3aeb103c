"""Online RGB-D implicit fusion entry point (PyTorch/CUDA).

    python -m nerf_fusion_tpu_torch.main configs/fusion-synth.yaml \
        [--device cuda|cpu] [--max_frames N] [--output DIR] [--gt_pose 1]
        [--load_map map.npz]

Reads the same YAML and ``hyper.json`` as the JAX entry point and writes
the same ``trajectory.txt``, ``mesh.ply``, ``map.npz`` and ``stats.json``
into ``--output``.  Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import importlib
import logging

import torch

from .models.io import load_model
from .system.pipeline import FusionPipeline
from .utils import config as exp_util
from .utils.se3 import Isometry, Quaternion


def build_sequence(args, device):
    seq_package, seq_class = args.sequence_type.split(".")
    try:
        module = importlib.import_module(f"{__package__}.data.{seq_package}")
    except ModuleNotFoundError as e:
        raise NotImplementedError(
            f"sequence type {args.sequence_type!r} is not ported yet") from e
    cls = getattr(module, seq_class)
    return cls(load_gt=True, device=device, **args.sequence_kwargs)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return device


def main(argv=None):
    parser = exp_util.ArgumentParserX()
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--gt_pose", type=int, default=0,
                        help="fuse with ground-truth poses (mapping-only mode)")
    parser.add_argument("--output", type=str, default="output/fusion",
                        help="output directory for trajectory/mesh/stats")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--load_map", type=str, default=None,
                        help="resume fusion from a saved map.npz")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # f32 products everywhere: the tracker's Jacobians need the digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)

    model, model_args = load_model(args.training_hypers, args.using_epoch)
    args.model = model_args
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.tracking = exp_util.dict_to_args(args.tracking)
    if getattr(args, "sequence_kwargs", {}).get("first_tq") is not None:
        tq = args.sequence_kwargs.pop("first_tq")
        args.first_iso = Isometry(q=Quaternion(array=tq[3:]), t=tq[:3])

    sequence = build_sequence(args, device)
    pipeline = FusionPipeline(model, args, device)
    if args.load_map:
        pipeline.map.load(args.load_map)
        pipeline.map.updated_slots[:] = True    # re-mesh everything once
    results = pipeline.run(sequence, use_gt_pose=bool(args.gt_pose),
                           max_frames=args.max_frames, output_dir=args.output)
    logging.info("results: %s", results)
    return results


if __name__ == "__main__":
    main()
