"""Encoder-decoder training entry point.

    python -m nerf_fusion_tpu_torch.network_trainer configs/train-cnp.yaml \
        [--resume N] [--device cuda|cpu] [--num_epochs N]
        [--exec "train_set[0]['data_path']='DIR';max_steps_per_epoch=20"]

Reads the same YAML as the JAX entry point (``network_trainer.py``) and
writes the same run directory, ``<save_dir>/<run_name>``: ``hyper.json``,
``logs/scalars.jsonl``, and at each snapshot epoch ``model_<e>.npz``,
``encoder_<e>.npz`` and ``training_<e>.npz`` (either package loads them)
with ``optimizer_<e>.pt`` (both Adam states, for ``--resume``).  Trains on
the GPU unless ``--device cpu`` is given; without a GPU it raises.
``--dp`` above 1 raises: data parallelism is not ported yet.
"""

from __future__ import annotations

import logging

import torch

from .main import resolve_device
from .trainer.train import train
from .utils import config as exp_util


def main(argv=None, step_hook=None):
    """Parse ``argv`` and train; ``step_hook`` goes to ``trainer.train.train``."""
    logging.basicConfig(level=logging.INFO)
    parser = exp_util.ArgumentParserX()
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel degree (above 1 is not ported yet)")
    parser.add_argument("--resume", type=int, default=None,
                        help="resume from this snapshot epoch in the run directory")
    args = parser.parse_args(argv)
    if args.dp > 1:
        from .parallel import data_parallel

        data_parallel(args.dp)
    device = resolve_device(args.device)
    # f32 products, as the JAX trainer's Precision.HIGH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, save_dir = train(args, resume_epoch=args.resume, device=device, step_hook=step_hook)
    logging.info("training complete; checkpoints in %s", save_dir)
    return save_dir


if __name__ == "__main__":
    main()
