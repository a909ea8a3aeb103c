"""The result line: end-to-end metrics from the host clock and the events,
per-layer metrics from their readers (``metrics/<name>.py``)."""

from __future__ import annotations

import math
import sys

from . import discovery
from .arith import percentile


def reports(entry: dict, cell: dict, bench: dict) -> bool:
    """Whether ``cell`` reports the metric ``entry``."""
    if "workloads" in entry:
        return cell["name"] in entry["workloads"]
    if "moves" in entry:
        moved = next(m for m in bench["end_to_end"] if m["name"] == entry["moves"])
        return reports(moved, cell, bench)
    return True


def end_to_end(ctx: dict) -> dict:
    frames = len(ctx["interval_ms"])
    p99, beyond = percentile(ctx["interval_ms"], 99)
    print(f"frame_ms_p99: {frames} frame intervals, {beyond} above the 99th percentile",
          flush=True)
    half = frames // 2
    for name, part in (("first", ctx["interval_ms"][:half]), ("second", ctx["interval_ms"][half:])):
        cad = [m for f, m in zip(ctx["frame_ids"][:half] if name == "first"
                                 else ctx["frame_ids"][half:], part) if f % ctx["cadence"] == 0]
        print(f"window {name} half: {len(part)} frames, {1e3 * len(part) / sum(part):.6g} "
              f"frames/s by events, p99 {percentile(part, 99)[0]:.6g} ms, cadence frames "
              f"{len(cad)} at {sum(cad) / max(len(cad), 1):.6g} ms", file=sys.stderr, flush=True)
    return {"fps": frames / ctx["window_s"], "frame_ms_p99": p99, "setup_s": ctx["setup_s"]}


def result(out: dict, cell: dict, trace: bool) -> dict:
    bench = discovery.benchmark()
    ctx = out["ctx"]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if reports(m, cell, bench):
                v = discovery.metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end(ctx)
        for m in bench["end_to_end"]:
            if reports(m, cell, bench):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    device = {"platform": "gpu", "kind": out["kind"], "count": out["count"],
              "memory_peak_bytes": out["memory_peak"]}
    res = {"correct": out["failed"] == 0, "attempted": len(ctx["frame_ids"]),
           "failed": out["failed"], "metrics": metrics, "device": device}
    tr = ctx.get("trace")
    if trace and tr is not None and "trace" in tr:
        device["busy_s"] = tr["trace"].busy_s
        device["window_s"] = tr["trace"].window_s
        res["breakdown"] = {"device_ops": tr["trace"].top_device_ops(),
                            "idle_gaps": tr["trace"].idle_by_host()}
    print(f"device: {out['kind']}, {ctx['power_limit']}", file=sys.stderr, flush=True)
    # a number that could not be read (no cloud, no batch) is infinite: null here
    res["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                     for k, (v, lim) in out["checks"].items()}
    return res
