"""The control of a cell, and the program's readings beside it, on the card.

    python3 fusion_bench/control.py --workload room.orbit --seconds 3 --seeds 11 12 13

For each seed one run of the cell with a short window (as the benchmark
runs it, in one process), then the check twice: the program against the
float32 reference, and the reference one precision lower in the program's
place (``reference.precision.CONTROL``).  Prints one JSON line a seed with
both sides' readings; the limits in ``limits.json`` lie between the two.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    opts = p.parse_args(argv)
    sys.path[:] = [str(HERE.parent)] + [q for q in sys.path if Path(q or ".").resolve() != HERE]
    import torch

    from fusion_bench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in opts.seeds:
        out = harness.run_cell(opts.workload, seed, opts.seconds, False,
                               control=True)
        print(json.dumps({"workload": opts.workload, "seed": seed,
                          "frames": len(out["ctx"]["frame_ids"]), **out["readings"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
