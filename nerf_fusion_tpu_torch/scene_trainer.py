"""Per-scene trainer entry point: fit the prior from an RGB-D sequence.

    python -m nerf_fusion_tpu_torch.scene_trainer configs/train_scannet.yaml \
        [--max_frames N] [--device cuda|cpu] [--exec "num_epochs=2;..."]

Counterpart of the JAX entry point ``scene_trainer.py``: the config's
sequence (``synth``, ``scannet`` or ``icl_nuim``, with ground-truth poses;
a disk reader decoded ahead as ``main.py`` reads it) is harvested into
LIFs on the device and the trainer fits the prior to them
(``trainer/scene.py``); the run directory is the trainer's, with
``harvest.json`` beside the snapshots.  Runs on the GPU unless
``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

import logging

import torch

from .main import build_sequence, resolve_device
from .trainer.scene import train_scene
from .utils import config as exp_util


def main(argv=None, step_hook=None):
    """Parse ``argv``, harvest and train; returns the run directory."""
    logging.basicConfig(level=logging.INFO)
    parser = exp_util.ArgumentParserX()
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # f32 products, as the JAX trainer's Precision.HIGH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sequence = build_sequence(args, device)
    try:
        _, save_dir = train_scene(args, sequence, max_frames=args.max_frames, device=device,
                                  step_hook=step_hook)
    finally:
        if hasattr(sequence, "close"):
            sequence.close()
    logging.info("scene training complete; checkpoints in %s", save_dir)
    return save_dir


if __name__ == "__main__":
    main()
