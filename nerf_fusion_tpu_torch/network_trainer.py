"""Encoder-decoder training entry point.

    python -m nerf_fusion_tpu_torch.network_trainer configs/train-cnp.yaml \
        [--resume N] [--device cuda|cpu] [--dp N] [--num_epochs N]
        [--exec "train_set[0]['data_path']='DIR';max_steps_per_epoch=20"]

Reads the same YAML as the JAX entry point (``network_trainer.py``) and
writes the same run directory, ``<save_dir>/<run_name>``: ``hyper.json``,
``logs/scalars.jsonl``, and at each snapshot epoch ``model_<e>.npz``,
``encoder_<e>.npz`` and ``training_<e>.npz`` (either package loads them)
with ``optimizer_<e>.pt`` (both Adam states, for ``--resume``).  Trains on
the GPU unless ``--device cpu`` is given; without a GPU it raises.

``--dp N`` trains data-parallel in N processes, one per device (NCCL on
``cuda:0`` .. ``cuda:N-1``, gloo on the CPU; ``parallel.launch``): each
takes ``batch_size / N`` of every global batch, which must divide.  Under
``torchrun`` the process joins the launcher's group.
"""

from __future__ import annotations

import logging
import sys

import torch

from . import parallel
from .main import resolve_device
from .trainer.train import run_dir, train
from .utils import config as exp_util


def parse(argv):
    parser = exp_util.ArgumentParserX()
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel degree: processes, one per device (0: one "
                             "process, no process group)")
    parser.add_argument("--resume", type=int, default=None,
                        help="resume from this snapshot epoch in the run directory")
    return parser.parse_args(argv)


def run(device, argv, step_hook=None, dp: bool = False):
    """Train as ``argv`` says on ``device``; with ``dp`` as one rank of the
    process group this process is in."""
    logging.basicConfig(level=logging.INFO)   # a spawned rank starts unconfigured
    args = parse(argv)
    # f32 products, as the JAX trainer's Precision.HIGH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, save_dir = train(args, resume_epoch=args.resume, device=device, step_hook=step_hook,
                        dp=dp)
    return save_dir


def main(argv=None, step_hook=None):
    """Parse ``argv`` and train; ``step_hook`` goes to ``trainer.train.train``
    where rank 0 runs in this process (not with ``--dp`` above 1)."""
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    device = resolve_device(args.device)
    n = args.dp or parallel.torchrun_world()
    if n == 0:
        save_dir = run(device, argv, step_hook)
    else:
        if args.batch_size % n:
            raise ValueError(f"batch_size {args.batch_size} is not a multiple of the "
                             f"data-parallel degree {n}")
        hook = step_hook if n == 1 or parallel.torchrun_world() else None
        parallel.launch(run, n, device, (argv, hook, True))
        save_dir = run_dir(args)
    logging.info("training complete; checkpoints in %s", save_dir)
    return save_dir


if __name__ == "__main__":
    main()
