"""Finding a cell's parts by name.

``BENCHMARK.json`` (the checkout's root) lists the cells and metrics.  A
configuration is the file its entry names; a traffic mix is
``traffic/<name>.json``; a per-layer metric is ``metrics/<name>.py`` with a
``read(ctx)`` that returns the value or None; a kernel's work is
``rooflines/<kernel>.py`` with ``work(**sizes) -> (operations, bytes,
peak operations per second)``.  Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent


def benchmark() -> dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(CHECKOUT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"fusion_bench_part_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(ctx)`` of the per-layer metric ``name``."""
    return _load(ROOT / "metrics" / f"{name}.py").read


def roofline(kernel: str):
    """``work(**sizes)`` of ``kernel``: (operations, bytes, peak op/s)."""
    return _load(ROOT / "rooflines" / f"{kernel}.py").work


def bound_s(kernel: str, **sizes) -> float:
    """The least time of one call of ``kernel`` at ``sizes``: the larger of
    its operations at its unit's peak and its bytes at the HBM rate."""
    from .rooflines import HBM_BYTES_PER_S

    ops, nbytes, peak = roofline(kernel)(**sizes)
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)
