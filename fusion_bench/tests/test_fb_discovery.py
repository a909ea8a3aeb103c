"""A configuration, a traffic mix, a per-layer metric and a kernel's work
dropped into a copy of the benchmark as new files are found by name, with
no file already there edited, and a run of the new cell reports the new
metric."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent

RUN = """
import json, sys
sys.path[:0] = [{copy!r}, {checkout!r}]
import fusion_bench
assert fusion_bench.__file__.startswith({copy!r}), fusion_bench.__file__
from fusion_bench import discovery, harness, metrics_io
from fusion_bench.tests.tiny import TINY
bench = discovery.benchmark()
cell = discovery.cell(bench, "dummy.slow_orbit")
print("config", discovery.config(bench, cell["config"])["fusion"]["integrate_interval"])
print("traffic", discovery.traffic(cell["traffic"])["trajectory"]["radius"])
print("bound", discovery.bound_s("dummy_kernel", rows=10))
out = harness.run_cell("dummy.slow_orbit", 5, 3.0, True, device="cpu", overrides=TINY,
                       log=lambda m: None)
res = metrics_io.result(out, cell, True)
print("metrics", json.dumps(sorted(res["metrics"])))
print("value", res["metrics"]["dummy.frames_seen"]["value"])
"""


def test_new_files_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT, copy / "fusion_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    before = {p.relative_to(copy): p.read_bytes() for p in (copy / "fusion_bench").rglob("*")
              if p.is_file()}
    fb = copy / "fusion_bench"
    cfg = json.loads((fb / "configs" / "difusion-room.json").read_text())
    cfg["fusion"]["integrate_interval"] = cfg["fusion"]["meshing_interval"] = 10
    (fb / "configs" / "dummy-room.json").write_text(json.dumps(cfg))
    traffic = json.loads((fb / "traffic" / "orbit.json").read_text())
    traffic["trajectory"]["radius"] = 1.9
    (fb / "traffic" / "slow_orbit.json").write_text(json.dumps(traffic))
    (fb / "metrics" / "dummy.frames_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx['frame_ids']))\n")
    (fb / "rooflines" / "dummy_kernel.py").write_text(
        "def work(rows):\n    return 2.0 * rows, 4.0 * rows, 1e12\n")
    bench["configs"].append({"name": "dummy-room", "source": "test",
                             "file": "fusion_bench/configs/dummy-room.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "dummy.slow_orbit", "config": "dummy-room",
                               "traffic": "slow_orbit", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy.frames_seen", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "frame_ms_p99",
                               "workloads": ["dummy.slow_orbit"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RUN.format(copy=str(copy),
                                                           checkout=str(CHECKOUT))],
                         capture_output=True, text=True, timeout=600, cwd=str(copy))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.strip().splitlines())
    assert lines["config"] == "10"
    assert lines["traffic"] == "1.9"
    assert float(lines["bound"]) == 20.0 / 1e12
    assert "dummy.frames_seen" in json.loads(lines["metrics"])
    assert float(lines["value"]) > 0
    after = {p.relative_to(copy): p.read_bytes() for p in (copy / "fusion_bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
