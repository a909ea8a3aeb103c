"""Where the fusion loop's time goes on the GPU.

    python -m nerf_fusion_tpu_torch.profile_loop configs/fusion-synth.yaml \
        [--warm 21] [--frames 20]

Runs the loop for ``--warm`` frames, times the next ``--frames`` frames
(window A) on the host clock, then traces the ``--frames`` after those
(window B, the same mix of frames: one integrate + mesh cadence each at
the default 20-frame interval) with ``torch.profiler``.  Prints per frame
the wall time of A, the device-busy time of B (the sum of the kernel
durations; one stream, so kernels do not overlap) and the device's idle
share 1 - busy / wall; then the 15 costliest kernels of B.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .main import build_sequence
from .models.io import load_model
from .system.pipeline import FusionPipeline
from .utils import config as exp_util


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--warm", type=int, default=21)
    parser.add_argument("--frames", type=int, default=20)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_loop measures the GPU; no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    args = exp_util.parse_config_yaml(opts.config)
    model, args.model = load_model(args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.tracking = exp_util.dict_to_args(args.tracking)
    seq = build_sequence(args, dev)
    n = opts.frames
    frames = [seq.render_frame(i) for i in range(opts.warm + 2 * n)]
    pipe = FusionPipeline(model, args, dev)

    def run(lo, hi):
        for i in range(lo, hi):
            pipe.process_frame(frames[i], i)
        pipe.mesher.current_mesh()
        torch.cuda.synchronize()

    run(0, opts.warm)
    t0 = time.perf_counter()
    run(opts.warm, opts.warm + n)
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(opts.warm + n, opts.warm + 2 * n)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6 / n
    print(f"{torch.cuda.get_device_name(0)}: frames {opts.warm}..{opts.warm + n - 1} "
          f"wall {1e3 * wall:.3f} ms/frame; frames {opts.warm + n}..{opts.warm + 2 * n - 1} "
          f"device busy {1e3 * busy:.3f} ms/frame, {len(kernels) / n:.1f} kernels/frame; "
          f"device idle share {1 - busy / wall:.4f}")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t * 1e-3 / n:9.4f} ms/frame  {c / n:8.2f} calls/frame  {name[:100]}")


if __name__ == "__main__":
    main()
