"""The benchmark of the fusion loop (the PyTorch and CUDA port) on NVIDIA GPUs.

    python3 fusion_bench/run.py --workload room.orbit --seed 7 --seconds 15 --trace 0

Runs one cell of ``BENCHMARK.json`` (``harness.run_cell``) and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted`` (frames in the window), ``failed`` (numbers of the check out
of their limits), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared with its
limit.  The same numbers close standard error.  Exits non-zero without a
result when no CUDA device is there, or too few for the cell, or when a
JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    opts = p.parse_args(argv)
    # the checkout, not this folder, heads the path: a file here named like a
    # standard module must not shadow it
    sys.path[:] = [str(CHECKOUT)] + [q for q in sys.path if Path(q or ".").resolve() != HERE]
    os.environ.setdefault("USE_FLAX", "0")
    # one process, few threads: the host paces the loop, and idle pool threads
    # that spin take cores from it
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / ".fusion_bench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CHECKOUT / ".fusion_bench_cache" / "torch_extensions"))
    import torch

    torch.set_num_threads(1)
    from fusion_bench import discovery, harness, metrics_io

    cell = discovery.cell(discovery.benchmark(), opts.workload)
    if not torch.cuda.is_available():
        print("fusion_bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"fusion_bench: {opts.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import nerf_fusion_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"fusion_bench: the program is not in this checkout ({e})", file=sys.stderr)
        return 3
    out = harness.run_cell(opts.workload, opts.seed, opts.seconds, bool(opts.trace),
                           t_start=T_START)
    result = metrics_io.result(out, cell, bool(opts.trace))
    banned = sorted(set(out["banned"]) | set(harness.banned_modules()))
    if banned:
        print(f"fusion_bench: modules loaded that the benchmark must not load: {banned}",
              file=sys.stderr)
        return 4
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
