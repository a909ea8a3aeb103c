"""The layer split of a chrome trace that carries the program's spans
(``fusion_bench.spans``): on a synthetic trace, the device's work goes to
the layer whose span was open around the runtime call that launched it (by
correlation, a graph's kernels by their ``cudaGraphLaunch``), the idle gaps
to the loop thread's innermost span, and the layers' idle time with the
unspanned rest is the window's; the program's ``to_chrome`` puts a
recording on such a trace's clock and threads; ``main.py --profile``
writes a trace the split reads."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from fusion_bench import spans
from nerf_fusion_tpu_torch.utils import trace as program_trace

LOOP, OTHER = 101, 202
CHECKOUT = Path(__file__).resolve().parents[2]


def _call(name, ts, dur, corr, tid=LOOP):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _span(name, start_us, end_us, tid=LOOP, **args):
    return {"ph": "X", "cat": spans.PROGRAM, "name": name, "ts": start_us,
            "dur": end_us - start_us, "tid": tid, "args": args}


def _device_and_calls(extra=()):
    """Window 0-200 us.  tracker.prelude 10-30 launches k1 (at 40-60),
    tracker.eval 30-50 launches a graph (70-90 and 90-95), tracker.done_read
    50-100 holds a sync; map.integrate 120-150 launches k3 (150-170); an
    unspanned launch at 180 runs 185-190; a worker thread's mesher.select
    launches k5 (60-65) while the loop is in done_read."""
    return [
        _call("cudaEventSynchronize", 0, 2, 1), _call("cudaEventSynchronize", 198, 2, 2),
        _call("cudaLaunchKernel", 12, 3, 10), _kernel("k1", 40, 20, 10),
        _call("cudaGraphLaunch", 32, 10, 11), _kernel("g1", 70, 20, 11),
        _kernel("g2", 90, 5, 11),
        _call("cudaMemcpyAsync", 52, 3, 12), _call("cudaStreamSynchronize", 56, 40, 13),
        _call("cudaLaunchKernel", 125, 3, 14), _kernel("k3", 150, 20, 14),
        _call("cudaLaunchKernel", 180, 2, 15), _kernel("k4", 185, 5, 15),
        _call("cudaLaunchKernel", 55, 2, 16, tid=OTHER), _kernel("k5", 60, 5, 16),
        *extra]


SPANS = [("pipeline.frame", 5, 175, LOOP), ("tracker.track", 8, 110, LOOP),
         ("tracker.prelude", 10, 30, LOOP), ("tracker.eval", 30, 50, LOOP),
         ("tracker.done_read", 50, 100, LOOP), ("map.integrate", 120, 150, LOOP),
         ("worker.job", 40, 80, OTHER), ("mesher.select", 50, 70, OTHER)]


def _trace(extra=()):
    events = _device_and_calls(extra) + [
        _span(n, s, e, tid, **({"frame": 0, "cadence": True} if n == "pipeline.frame" else {}))
        for n, s, e, tid in SPANS]
    return spans.SpanTrace(events)


def test_work_goes_to_the_span_around_its_launch():
    got = spans.by_layer(_trace())
    assert got["busy_us"]["tracker"] == pytest.approx(20 + 25)       # k1, the graph
    assert got["busy_us"]["map"] == pytest.approx(20)
    assert got["busy_us"]["mesher"] == pytest.approx(5)              # the worker's k5
    assert got["busy_us"][None] == pytest.approx(5)                  # k4, unspanned
    assert got["attributed_us"] == pytest.approx(20 + 25 + 20 + 5)
    assert got["unattributed"] == [(("k4", "no span"), pytest.approx(5))]
    assert got["calls_on_span_threads"] == (6, 6)
    assert (got["frames"], got["cadence_frames"]) == (1, 1)
    # inside pipeline.frame: k1, the graph, k3 (the worker's k5 and k4 lie outside)
    assert got["frame_us"] == got["frame_attributed_us"] == pytest.approx(20 + 25 + 20)


def test_frame_work_outside_a_layer_span_is_named_by_its_span():
    """A launch inside ``pipeline.frame`` but outside the layers' spans
    counts in the frames' work and not in its attributed part."""
    got = spans.by_layer(_trace([_call("cudaLaunchKernel", 112, 2, 18),
                                 _kernel("k8", 172, 2, 18)]))
    assert got["frame_us"] == pytest.approx(20 + 25 + 20 + 2)
    assert got["frame_attributed_us"] == pytest.approx(20 + 25 + 20)
    assert got["unattributed_by_span"] == {"pipeline.frame": pytest.approx(2),
                                           "no span": pytest.approx(5)}
    s = spans.summary(_trace([_call("cudaLaunchKernel", 112, 2, 18),
                              _kernel("k8", 172, 2, 18)]))
    assert s["frames_attributed_share"] == pytest.approx(65 / 67)


def test_launch_on_an_unknown_thread_goes_to_no_layer():
    """A runtime call on a thread that recorded no span is charged to no
    layer, whatever span the loop's thread has open then, and is left out
    of the attributed share; so is a device event with no runtime call."""
    got = spans.by_layer(_trace([_call("cudaLaunchKernel", 31, 2, 17, tid=303),
                                 _kernel("k6", 100, 10, 17), _kernel("k7", 110, 4, 99)]))
    assert got["busy_us"]["tracker"] == pytest.approx(20 + 25)       # not k6: eval was open
    assert got["busy_us"][None] == pytest.approx(5 + 10 + 4)
    assert got["attributed_us"] == pytest.approx(20 + 25 + 20 + 5)
    assert got["program_us"] == pytest.approx(got["attributed_us"])
    assert dict(got["unattributed"]) == {("k4", "no span"): pytest.approx(5),
                                         ("k6", "unknown thread"): pytest.approx(10),
                                         ("k7", "unknown thread"): pytest.approx(4)}
    assert got["calls_on_span_threads"] == (6, 8)


def test_idle_gaps_partition_the_window():
    tr = _trace()
    got = spans.by_layer(tr)
    # gaps: 0-40 (mid 20: prelude), 65-70 (mid 67.5: done_read), 95-150 (mid 122.5:
    # map.integrate), 170-185 (mid 177.5: none), 190-200 (mid 195: none)
    assert got["idle_us"]["tracker"] == pytest.approx(40 + 5)
    assert got["idle_us"]["map"] == pytest.approx(55)
    assert got["idle_us"][None] == pytest.approx(15 + 10)
    assert sum(got["idle_us"].values()) == pytest.approx(got["idle_us_total"])
    assert got["idle_us_total"] == pytest.approx(1e6 * (tr.window_s - tr.busy_s))
    assert spans.done_reads(tr) == (1, 1, pytest.approx(2))
    assert dict(got["idle_by_span_and_call"]) == {
        ("tracker.prelude", "(no host operation)"): pytest.approx(40),
        ("tracker.done_read", "cudaStreamSynchronize"): pytest.approx(5),
        ("map.integrate", "(no host operation)"): pytest.approx(55),
        ("no span", "(no host operation)"): pytest.approx(25)}
    s = spans.summary(tr)
    assert s["idle_ms_partitioned"] == pytest.approx(s["idle_ms_total"])
    assert s["idle_ms_a_frame"] == {"tracker": pytest.approx(0.045),
                                    "map": pytest.approx(0.055),
                                    "unspanned": pytest.approx(0.025)}
    assert s["attributed_share"] == pytest.approx(70 / 75)


def test_innermost_segments_of_nested_spans():
    segs = spans.segments([("a", 0, 10), ("b", 2, 4), ("c", 4, 8), ("d", 5, 6), ("e", 12, 13)])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 5, "c"), (5, 6, "d"), (6, 8, "c"),
                    (8, 10, "a"), (12, 13, "e")]


def test_a_trace_without_spans_reads_nothing():
    tr = spans.SpanTrace(_device_and_calls())
    assert spans.by_layer(tr) is None and spans.summary(tr) == {"spans": 0}


def test_to_chrome_puts_a_recording_on_the_trace_clock_and_threads(tmp_path):
    """The program's clock runs 5 s behind the trace's, in nanoseconds; the
    trace names the anchors' thread (native id 7) 101 and the worker's
    thread by its native id: the split then reads as on the trace above."""
    native = {LOOP: 7, OTHER: OTHER}
    rec = {"spans": [{"name": n, "start_ns": int((s - 5e6) * 1e3),
                      "end_ns": int((e - 5e6) * 1e3), "tid": native[tid], "id": i,
                      "parent": None, "frame": 0,
                      "attrs": {"cadence": True} if n == "pipeline.frame" else {}}
                     for i, (n, s, e, tid) in enumerate(SPANS)],
           "counters": {}, "anchor_event": "cudaEventSynchronize", "anchor_tid": 7,
           "anchors": [(int((0 - 5e6) * 1e3), int((2 - 5e6) * 1e3)),
                       (int((198 - 5e6) * 1e3), int((200 - 5e6) * 1e3))]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _device_and_calls()}))
    program_trace.to_chrome(rec, path)
    tr = spans.SpanTrace.load(path)
    assert sorted(tr.spans) == [LOOP, OTHER]
    assert sorted((n, s, e) for n, s, e, _ in tr.spans[LOOP]) == pytest.approx(
        sorted((n, s, e) for n, s, e, t in SPANS if t == LOOP))
    assert spans.by_layer(tr) == spans.by_layer(_trace())


def test_entry_profile_trace_reads(tmp_path):
    """``main.py --profile`` on the CPU, three frames: the split reads its
    trace, finds the three frames, and partitions the window's idle time."""
    from nerf_fusion_tpu_torch import main as entry

    ckpt = CHECKOUT / "ckpt" / "default" / "hyper.json"
    cfg = (CHECKOUT / "configs" / "fusion-synth.yaml").read_text().replace(
        'training_hypers: "ckpt/default/hyper.json"', f'training_hypers: "{ckpt}"')
    (tmp_path / "synth.yaml").write_text(cfg)
    small = ("sequence_kwargs['width']=160;sequence_kwargs['height']=120;"
             "mapping['latent_capacity']=8192;mapping['points_capacity']=4096")
    entry.run([str(tmp_path / "synth.yaml"), "--device", "cpu", "--max_frames", "3",
               "--output", str(tmp_path / "out"), "--profile", str(tmp_path / "prof"),
               "--exec", small])
    out = subprocess.run([sys.executable, "-m", "fusion_bench.spans",
                          str(tmp_path / "prof" / "trace.json")], cwd=CHECKOUT,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout)
    assert got["frames"] == 3
    assert got["idle_ms_partitioned"] == pytest.approx(got["idle_ms_total"], rel=1e-9)
