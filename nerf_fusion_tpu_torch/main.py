"""Online RGB-D implicit fusion entry point (PyTorch/CUDA).

    python -m nerf_fusion_tpu_torch.main configs/fusion-synth.yaml \
        [--device cuda|cpu] [--max_frames N] [--output DIR] [--gt_pose 1]
        [--load_map map.npz] [--profile DIR] [--vis 1 [--vis_interval N]]

Reads the same YAML and ``hyper.json`` as the JAX entry point and writes
the same ``trajectory.txt``, ``mesh.ply``, ``map.npz`` and ``stats.json``
into ``--output``.  Runs on the GPU unless ``--device cpu`` is given.
A disk reader (a sequence with ``load_frame``) is wrapped in a
``PrefetchSequence`` unless the config says ``prefetch: false``; on the GPU
its frames go up on a side stream unless ``prefetch_upload: false``.
``--profile DIR`` writes a ``torch.profiler`` trace of the run there
(``trace.json``, for Perfetto or chrome://tracing) with the program's spans
(``utils/trace.py``) on it as events of category ``program_span``, on the
trace's clock: the kernels and the layer whose host code launched them in
one view.
``--vis 1`` writes a mesh, trajectory and voxel-block preview every
``vis_interval`` frames under ``<output>/preview``.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import logging
from pathlib import Path

import torch

from .models.io import load_model
from .system.pipeline import FusionPipeline
from .utils import config as exp_util
from .utils import trace as program_trace
from .utils.se3 import Isometry, Quaternion


def build_sequence(args, device):
    seq_package, seq_class = args.sequence_type.split(".")
    try:
        module = importlib.import_module(f"{__package__}.data.{seq_package}")
    except ModuleNotFoundError as e:
        raise NotImplementedError(
            f"sequence type {args.sequence_type!r} is not ported yet") from e
    cls = getattr(module, seq_class)
    kwargs = dict(args.sequence_kwargs)
    params = inspect.signature(cls).parameters
    # first_tq stays in the config for the readers that take it (ICL-NUIM's
    # puts its ground truth in the frame of first_iso with it)
    if "first_tq" not in params:
        kwargs.pop("first_tq", None)
    if "device" in params:          # a renderer; the disk readers return host frames
        kwargs["device"] = device
    seq = cls(load_gt=True, **kwargs)
    # disk readers decode ahead on a thread pool (the loop would otherwise
    # wait on each PNG decode); on the GPU the frames also go up ahead
    if getattr(args, "prefetch", True) and hasattr(seq, "load_frame"):
        from .data.prefetch import PrefetchSequence

        device = torch.device(device)
        upload = device.type == "cuda" and bool(getattr(args, "prefetch_upload", True))
        seq = PrefetchSequence(seq, depth=4, workers=2, upload=upload, device=device)
    return seq


def set_first_iso(args):
    """``first_iso`` from ``sequence_kwargs['first_tq']`` ([tx, ty, tz, qx,
    qy, qz, qw]) where the config gives one; ``first_tq`` stays, as the
    JAX entry point leaves it, for the sequence readers that take it."""
    tq = getattr(args, "sequence_kwargs", {}).get("first_tq")
    if tq is not None:
        args.first_iso = Isometry(q=Quaternion(array=tq[3:]), t=tq[:3])


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return device


def main(argv=None):
    return run(argv)[1]


def run(argv=None):
    """The entry point's work: (the pipeline, its results)."""
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
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler trace of the run to this directory")
    parser.add_argument("--vis_interval", type=int, default=None,
                        help="with --vis 1: frames between previews (default: the "
                             "config's vis_interval, else meshing_interval)")
    args = parser.parse_args(argv)
    if args.vis_interval is None:       # the flag shadows a config's own key
        args.vis_interval = getattr(exp_util.parse_config_yaml(Path(args.hyper)),
                                    "vis_interval", None)
    logging.basicConfig(level=logging.INFO)
    if getattr(args, "vis", False):
        logging.info("Headless visualization: periodic mesh/trajectory/voxel-block "
                     "previews every %s frames under %s/preview",
                     args.vis_interval or args.meshing_interval, args.output)
    # f32 products everywhere: the tracker's Jacobians need the digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)

    model, model_args = load_model(args.training_hypers, args.using_epoch)
    args.model = model_args
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.tracking = exp_util.dict_to_args(args.tracking)
    set_first_iso(args)

    sequence = build_sequence(args, device)
    pipeline = FusionPipeline(model, args, device)
    if args.load_map:
        pipeline.map.load(args.load_map)
        pipeline.map.updated_slots[:] = True    # re-mesh everything once
    prof = spans = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        spans = program_trace.capture()
    try:
        with prof, spans:
            results = pipeline.run(sequence, use_gt_pose=bool(args.gt_pose),
                                   max_frames=args.max_frames, output_dir=args.output)
    finally:
        if hasattr(sequence, "close"):
            sequence.close()
    if args.profile:
        trace = Path(args.profile) / "trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        program_trace.to_chrome(spans.export(), trace)
        logging.info("profiler trace and the program's spans written to %s", trace)
    logging.info("results: %s", results)
    return pipeline, results


if __name__ == "__main__":
    main()
