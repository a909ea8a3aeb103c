"""The port's span and counter recorder (``nerf_fusion_tpu_torch/utils/trace.py``)
and the spans the fusion loop records with it.

* Records: nesting and parent ids, the frame id every span under a frame
  inherits, the native thread id, a worker job tied to the span that
  submitted it, counters; a capture drains, and one at a time.
* Off: ``span`` is the one shared no-op object and nothing is recorded.
* ``stats.json``'s ``timing`` keeps its stages and fields, built from the
  spans' totals (a summary keeps no other name); its ``counters`` are the
  run's.
* The clock: spans mapped through the capture's anchors onto a
  ``torch.profiler`` trace enclose the operators they issued, within 50 us;
  in the fusion loop every operator of a frame lies under a layer's span.
* ``main --profile`` writes the spans onto the profiler's trace.
"""

import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.system.pipeline import STAGES, FusionPipeline
from nerf_fusion_tpu_torch.system.worker import Worker
from nerf_fusion_tpu_torch.utils import config as exp_util
from nerf_fusion_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parent.parent
LAYERS = ("frontend", "tracker", "map", "mesher")
SLACK_US = 50.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_nesting_parents_frames_threads_and_counters():
    seen = {}
    with trace.capture() as cap:
        with trace.span("pipeline.frame", frame=7, attrs={"cadence": True}) as root:
            with trace.span("tracker.track") as track:
                with trace.span("tracker.eval") as ev:
                    trace.count("tracker.gn_evals.g0")
                trace.count("tracker.gn_evals.g0", 4)

            def job():
                with trace.span("worker.job", parent=root) as w:
                    seen["w"] = w
                    with trace.span("mesher.select"):
                        pass

            t = threading.Thread(target=job)
            t.start()
            t.join()
        with trace.span("pipeline.join") as after:
            pass
    rec = cap.export()
    by = {s["name"]: s for s in rec["spans"]}
    assert [s["name"] for s in rec["spans"]] == [
        "tracker.eval", "tracker.track", "mesher.select", "worker.job", "pipeline.frame",
        "pipeline.join"]
    assert by["pipeline.frame"]["parent"] is None and after.parent is None
    assert by["tracker.track"]["parent"] == root.id and ev.parent == track.id
    assert by["worker.job"]["parent"] == root.id
    assert by["mesher.select"]["parent"] == seen["w"].id
    assert {by[n]["frame"] for n in ("pipeline.frame", "tracker.track", "tracker.eval",
                                     "worker.job", "mesher.select")} == {7}
    assert by["pipeline.join"]["frame"] is None
    assert by["pipeline.frame"]["attrs"] == {"cadence": True}
    main = threading.get_native_id()
    assert by["tracker.eval"]["tid"] == main and by["worker.job"]["tid"] == seen["w"].tid
    assert seen["w"].tid != main
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    assert root.start <= track.start <= ev.start <= ev.end <= track.end <= root.end
    assert len({s["id"] for s in rec["spans"]}) == len(rec["spans"])
    assert rec["counters"] == {"tracker.gn_evals.g0": 5}
    assert len(rec["anchors"]) == 2 and rec["anchor_event"] == trace.ANCHOR
    assert rec["anchor_tid"] == main


def test_off_is_one_shared_noop_and_records_nothing():
    assert trace.active() is None
    assert trace.span("tracker.eval") is trace.NOOP
    assert trace.span("pipeline.frame", frame=3, attrs={"cadence": False}) is trace.NOOP
    with trace.span("tracker.eval") as sp:
        trace.count("mesher.extractions")
        assert sp is trace.NOOP and trace.current() is None
    with trace.capture() as cap:
        pass
    assert cap.export()["spans"] == [] and cap.counters == {}


def test_capture_drains_and_is_one_at_a_time():
    with trace.capture() as first:
        with trace.span("map.integrate"):
            pass
        trace.count("mesher.extractions")
        with pytest.raises(RuntimeError):
            with trace.capture():
                pass
        late = trace.span("mesher.extract")
        late.__enter__()
    late.__exit__(None, None, None)          # closed after the capture: not kept
    with trace.span("map.integrate"):        # off again
        pass
    trace.count("mesher.extractions")
    assert [s["name"] for s in first.export()["spans"]] == ["map.integrate"]
    assert first.counters == {"mesher.extractions": 1}
    with trace.capture() as second:
        pass
    assert second.export()["spans"] == [] and second.counters == {}
    assert trace.active() is None and trace.current() is None


def test_summary_keeps_totals_only():
    with trace.capture(summary={"tracker.track"}) as cap:
        for _ in range(3):
            with trace.span("pipeline.frame", frame=1) as frame:
                assert frame is trace.NOOP and trace.current() is None
                with trace.span("tracker.track") as track:
                    assert trace.current() is track
                    time.sleep(0.001)
                trace.count("mesher.extractions")
    n, total, longest = cap.totals()["tracker.track"]
    assert n == 3 and total >= 3e6 and 1e6 <= longest <= total
    assert list(cap.totals()) == ["tracker.track"]
    rec = cap.export()
    assert rec["spans"] == [] and rec["anchors"] == [] and rec["anchor_event"] is None
    assert rec["counters"] == {"mesher.extractions": 3}


def test_threads_record_beside_each_other():
    """More threads than cores, switching every microsecond: no count is
    lost and every span's parent is the span open around it on its own
    thread."""
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.capture() as cap:
            def work(k):
                for i in range(n):
                    with trace.span("mesher.extract", frame=k):
                        with trace.span("mesher.select"):
                            trace.count("mesher.extractions")

            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = cap.export()
    assert rec["counters"] == {"mesher.extractions": n_threads * n}
    assert len(rec["spans"]) == 2 * n_threads * n
    by_id = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        if s["name"] == "mesher.select":
            up = by_id[s["parent"]]
            assert up["name"] == "mesher.extract" and up["tid"] == s["tid"]
            assert up["frame"] == s["frame"] and up["start_ns"] <= s["start_ns"]
    assert len({s["tid"] for s in rec["spans"]}) == n_threads


def test_worker_job_span_names_the_submitting_span():
    worker = Worker("cpu")
    with trace.capture() as cap:
        with trace.span("mesher.extract", frame=20) as sp:
            fut = worker.submit(lambda: 1)
        assert fut.result() == 1
    job = next(s for s in cap.export()["spans"] if s["name"] == "worker.job")
    assert job["parent"] == sp.id and job["frame"] == 20
    assert job["tid"] != threading.get_native_id()
    assert job["attrs"]["job"].endswith("<lambda>")


def _ops(doc, prefix="aten::"):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
            for e in doc["traceEvents"]
            if e.get("cat") == "cpu_op" and e["name"].startswith(prefix) and "dur" in e]


def _mapped(rec, doc):
    found = sorted((float(e["ts"]), float(e.get("dur", 0))) for e in doc["traceEvents"]
                   if e.get("name") == rec["anchor_event"])
    assert len(found) == 2 == len(rec["anchors"])
    a, b = trace.clock_map(rec["anchors"], found)
    assert b == pytest.approx(1e-3, rel=1e-2)         # the trace counts microseconds
    return [(s["name"], a + b * s["start_ns"], a + b * s["end_ns"], s["tid"])
            for s in rec["spans"]]


def test_spans_on_the_profiler_clock_enclose_their_operators(tmp_path):
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.capture() as cap:
            for i in range(4):
                with trace.span("mm", frame=i):
                    torch.mm(x, x)
                time.sleep(0.002)
                with trace.span("sort", frame=i):
                    torch.sort(x[0])
                time.sleep(0.002)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    spans = _mapped(cap.export(), doc)
    assert cap.anchor_event == trace.ANCHOR
    for op, name in (("aten::mm", "mm"), ("aten::sort", "sort")):
        events = [o for o in _ops(doc) if o[2] == op]
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == 4 and len(events) >= 4
        for _, a0, a1, tid in mine:      # each span holds its operator
            inside = [o for o in events if o[3] == tid and
                      a0 - SLACK_US <= o[0] and o[1] <= a1 + SLACK_US]
            assert inside
            events = [o for o in events if o not in inside]
        assert events == []              # and no operator is left over


def _args(tiny=True):
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    model, args.model = load_model(REPO / args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.mapping.latent_capacity, args.mapping.points_capacity = 8192, 4096
    args.tracking = exp_util.dict_to_args(args.tracking)
    args.integrate_interval = args.meshing_interval = 4
    args.max_n_triangles = 1 << 15
    return model, args


def test_stats_timing_keeps_its_stages_and_fields():
    model, args = _args()
    args.vis, args.vis_interval = False, 4
    res = FusionPipeline(model, args, "cpu").run(
        SyntheticSequence(n_frames=9, width=160, height=120))
    t = res["timing"]
    assert list(t) == ["track", "integrate", "mesh", "join", "final_mesh"]
    assert [k for k, _ in STAGES] == ["track", "integrate", "mesh", "vis_preview", "join",
                                      "final_mesh"]
    assert {k: v["count"] for k, v in t.items()} == {
        "track": 9, "integrate": 3, "mesh": 3, "join": 1, "final_mesh": 1}
    for v in t.values():
        assert set(v) == {"total_s", "count", "mean_ms", "max_ms"}
        assert v["total_s"] > 0 and v["max_ms"] >= v["mean_ms"] > 0
        assert v["mean_ms"] == pytest.approx(1e3 * v["total_s"] / v["count"])
    # the run's counters: each of the 8 tracked frames evaluates every group
    c = res["counters"]
    assert all(c[f"tracker.gn_evals.g{k}"] >= 8 for k in range(3))
    assert c["mesher.extractions"] >= 1 and c["mesher.voxels_decoded"] > 0
    assert trace.active() is None


@pytest.mark.parametrize("posed", [False, True])
def test_every_operator_of_a_frame_lies_under_a_layer_span(tmp_path, posed):
    """Five frames at 160x120 (the fourth integrates and meshes) under the
    profiler: each operator inside ``pipeline.frame`` lies inside a span of
    a layer, and the counters agree with the spans."""
    model, args = _args()
    # the coarse frames keep points, every integration moves latents, and
    # its voxels mesh
    args.tracking.preprocess = dict(getattr(args.tracking, "preprocess", {}), outlier_min_nb=4,
                                    normal_min_nb=3)
    args.mapping.encoder_count_th, args.mapping.ignore_count_th = 1e9, 0.0
    pipe = FusionPipeline(model, args, "cpu")
    seq = SyntheticSequence(n_frames=9, width=160, height=120)
    pipe.process_frame(next(seq), 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.capture() as cap:
            for i in range(1, 5):
                pipe.process_frame(next(seq), i, use_gt_pose=posed)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    rec = cap.export()
    spans = _mapped(rec, doc)
    names = {s["name"] for s in rec["spans"]}
    want = {"pipeline.frame", "tracker.track", "map.integrate", "mesher.extract",
            "mesher.select", "mesher.keep_read", "mesher.decode", "mesher.marching_cubes"}
    want |= {"frontend.preprocess", "tracker.finish"} if posed else {
        "tracker.prelude", "tracker.eval", "tracker.done_read", "tracker.epilogue"}
    assert want <= names
    frames = sorted(s["frame"] for s in rec["spans"] if s["name"] == "pipeline.frame")
    assert frames == [1, 2, 3, 4]
    assert all(s["frame"] in frames for s in rec["spans"])
    evals = sum(v for k, v in rec["counters"].items() if k.startswith("tracker.gn_evals.g"))
    assert evals == sum(1 for s in rec["spans"] if s["name"] == "tracker.eval")
    assert rec["counters"]["mesher.extractions"] == 1
    assert rec["counters"]["mesher.voxels_decoded"] > 0
    frame_spans = [s for s in spans if s[0] == "pipeline.frame"]
    layer_spans = [s for s in spans if s[0].split(".")[0] in LAYERS]
    ops = [o for o in _ops(doc) if any(f[1] <= o[0] <= f[2] for f in frame_spans)]
    assert len(ops) > 100
    loose = [o for o in ops if not any(
        s[3] == o[3] and s[1] - SLACK_US <= o[0] and o[1] <= s[2] + SLACK_US
        for s in layer_spans)]
    assert loose == []


def test_entry_profile_writes_spans_on_the_trace(tmp_path):
    from nerf_fusion_tpu_torch import main as entry

    ckpt = REPO / "ckpt" / "default" / "hyper.json"
    cfg = (REPO / "configs" / "fusion-synth.yaml").read_text().replace(
        'training_hypers: "ckpt/default/hyper.json"', f'training_hypers: "{ckpt}"')
    (tmp_path / "synth.yaml").write_text(cfg)
    small = ("sequence_kwargs['width']=160;sequence_kwargs['height']=120;"
             "mapping['latent_capacity']=8192;mapping['points_capacity']=4096")
    _, res = entry.run([str(tmp_path / "synth.yaml"), "--device", "cpu", "--max_frames", "3",
                        "--output", str(tmp_path / "out"), "--profile", str(tmp_path / "prof"),
                        "--exec", small])
    assert res["timing"]["track"]["count"] == 3
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    frames = [e for e in spans if e["name"] == "pipeline.frame"]
    assert [e["args"]["frame"] for e in frames] == [0, 1, 2]
    assert {"tracker.track", "pipeline.join", "pipeline.final_mesh"} <= {e["name"] for e in spans}
    ops = _ops(doc)
    first = min(o[0] for o in ops)
    last = max(o[1] for o in ops)
    assert all(first - 1e4 <= e["ts"] and e["ts"] + e["dur"] <= last + 1e4 for e in spans)
    assert all(e["tid"] == ops[0][3] for e in frames)
