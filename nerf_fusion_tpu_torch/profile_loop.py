"""Where the fusion loop's time goes on the GPU.

    python -m nerf_fusion_tpu_torch.profile_loop configs/fusion-synth.yaml \
        [--warm 21] [--frames 20] [--exec "STATEMENTS"]

Runs the loop for ``--warm`` frames, times the next ``--frames`` frames
(window A) on the host clock, then traces the ``--frames`` after those
(window B, the same mix of frames: one integrate + mesh cadence each at
the default 20-frame interval) with ``torch.profiler``.  A synthetic
sequence is rendered before the first window; a disk reader is read in the
windows through the entry point's ``PrefetchSequence``, as a run reads it.
Prints per frame the wall time of A, the device-busy time of B (the sum of the kernel
durations; one stream, so kernels do not overlap) and the device's idle
share 1 - busy / wall, the tracker's CUDA graph replays and host reads
(of the GN done flag) per frame over B, and the CUDA runtime calls that
launch work from the host per frame over B (kernels, copies, graphs);
then the 15 costliest kernels of B.  ``--exec``
overrides config keys as the entry point's does, e.g. the fast tracking
path: ``--exec "tracking['rgb']['pixel_budget']=24576;mesh_reuse_latent_eps=0.003"``.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .main import build_sequence, set_first_iso
from .models.io import load_model
from .system.pipeline import FusionPipeline
from .utils import config as exp_util


# CUDA runtime calls that put work on the device from the host
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--warm", type=int, default=21)
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--exec", type=str, default=None,
                        help="Python statements mutating the parsed config")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_loop measures the GPU; no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    args = exp_util.parse_config_yaml(opts.config)
    if opts.exec is not None:
        exp_util.apply_exec(args, opts.exec)
    model, args.model = load_model(args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.tracking = exp_util.dict_to_args(args.tracking)
    set_first_iso(args)
    seq = build_sequence(args, dev)
    n = opts.frames
    if hasattr(seq, "render_frame"):
        frames = iter([seq.render_frame(i) for i in range(opts.warm + 2 * n)])
    else:
        frames = seq
    pipe = FusionPipeline(model, args, dev)

    def run(lo, hi):
        for i in range(lo, hi):
            pipe.process_frame(next(frames), i)
        pipe.mesher.current_mesh()
        torch.cuda.synchronize()

    run(0, opts.warm)
    t0 = time.perf_counter()
    run(opts.warm, opts.warm + n)
    wall = (time.perf_counter() - t0) / n
    tracker = pipe.tracker
    replays, reads = tracker.graph_replays, tracker.host_reads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(opts.warm + n, opts.warm + 2 * n)
    replays, reads = tracker.graph_replays - replays, tracker.host_reads - reads
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    runtime = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCHES:
            runtime[e.name] = runtime.get(e.name, 0) + 1
    busy = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6 / n
    print(f"{torch.cuda.get_device_name(0)}: frames {opts.warm}..{opts.warm + n - 1} "
          f"wall {1e3 * wall:.3f} ms/frame; frames {opts.warm + n}..{opts.warm + 2 * n - 1} "
          f"device busy {1e3 * busy:.3f} ms/frame, {len(kernels) / n:.1f} kernels/frame; "
          f"device idle share {1 - busy / wall:.4f}; {replays / n:.2f} graph replays/frame, "
          f"{reads / n:.2f} host reads/frame; launches from the host per frame "
          f"{ {k: round(v / n, 2) for k, v in sorted(runtime.items())} }")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t * 1e-3 / n:9.4f} ms/frame  {c / n:8.2f} calls/frame  {name[:100]}")


if __name__ == "__main__":
    main()
