"""Where a training step's host time goes, with and without ``--dp 1``.

    python -m nerf_fusion_tpu_torch.tools.train_profile configs/train-cnp.yaml \
        --exec "train_set[0]['data_path']='DIR'" [--steps 20]

Runs ``network_trainer`` four times on the GPU, in the order no ``--dp``,
``--dp 1``, ``--dp 1``, no ``--dp`` (one epoch of ``--steps`` steps each,
the config otherwise as given), and traces steps 7-16 of each with
``torch.profiler``: the host's wall time a step, the operators with the
most host (self CPU) time a step, and the CUDA runtime calls that wait
on the device or on events.  GPU only; the profiler's own bookkeeping is
in the times.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import network_trainer
from ..main import resolve_device

WINDOW = (6, 16)        # the trace covers steps 7-16
TOP = 12
WAITS = ("cudaEventSynchronize", "cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventQuery", "cudaStreamWaitEvent")


class _Trace:
    def __init__(self):
        self.prof, self.wall = None, None

    def __call__(self, it):
        if it == WINDOW[0]:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif it == WINDOW[1]:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--exec", required=True, help="at least the LIF set's data_path")
    ap.add_argument("--steps", type=int, default=20)
    a = ap.parse_args(argv)
    device = resolve_device("cuda")
    n = WINDOW[1] - WINDOW[0]
    for label, dp in (("single", []), ("dp1", ["--dp", "1"]), ("dp1_again", ["--dp", "1"]),
                      ("single_again", [])):
        trace = _Trace()
        network_trainer.main([a.config, "--device", str(device), *dp, "--exec",
                              f"{a.exec};run_name='profile_{label}';num_epochs=1;"
                              f"max_steps_per_epoch={a.steps};additional_snapshots=[]"],
                             step_hook=trace)
        if trace.wall is None:
            raise RuntimeError(f"{label}: fewer than {WINDOW[1]} steps ran")
        ka = trace.prof.key_averages()
        print(f"{label}: {trace.wall * 1e3 / n:.3f} ms a step (host clock, steps "
              f"{WINDOW[0] + 1}-{WINDOW[1]}, {torch.cuda.get_device_name(0)})", flush=True)
        for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:TOP]:
            print(f"  {e.key[:56]:56s} {e.count / n:7.1f} calls {e.self_cpu_time_total / n / 1e3:8.3f} "
                  f"ms host a step", flush=True)
        waits = {e.key: e.count / n for e in ka if e.key in WAITS}
        print(f"  waits a step: {waits}", flush=True)


if __name__ == "__main__":
    main()
