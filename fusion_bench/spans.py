"""Device busy and idle time put down to the layer whose host code ran it,
from a chrome trace that carries the program's spans.

    python3 -m fusion_bench.spans prof/trace.json

``nerf_fusion_tpu_torch/main.py --profile DIR`` writes such a trace: the
``torch.profiler`` trace of the run, with the spans of
``nerf_fusion_tpu_torch/utils/trace.py`` added by its ``to_chrome`` as
events of category ``program_span`` on the trace's clock and on the
threads the trace gives.  Prints one JSON object (``summary``).

A span's layer is the first part of its name when that is one of
``LAYERS``.  At any moment the innermost open span of a thread decides:
its layer, or none (``pipeline.frame`` itself, a caller's loop).

* Busy: each kernel, copy and memset goes by its correlation id to the
  runtime call that launched it (a graph's kernels to its
  ``cudaGraphLaunch``) and to the innermost span of that call's thread at
  the call's midpoint; a layer's busy time is the union of its events.
  Work launched outside every span is the caller's own: ``program_us``
  leaves it out.  ``frame_us`` is the work launched inside
  ``pipeline.frame`` (``process_frame``), ``frame_attributed_us`` its part
  in a layer.  Work whose call lies on a thread that recorded no span (or
  that has no call) goes to no layer: it is listed as ``unknown thread``.
* Idle: each gap of the device inside the window (``arith.gaps``, as
  ``tracefile.Trace`` has them) goes to the innermost span of the loop's
  thread (the one that runs ``pipeline.frame``) at the gap's midpoint, so
  the layers' idle time and the unspanned rest add up to the window's idle
  time.

The numbers are of traced frames, which the profiler slows.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import Counter

from .arith import gaps, union_length
from .tracefile import DEVICE_CATS, Trace

LAYERS = ("frontend", "tracker", "map", "mesher")
PROGRAM = "program_span"
RUNTIME = ("cuda_runtime", "cuda_driver")


def layer_of(name: str):
    head = name.split(".", 1)[0]
    return head if head in LAYERS else None


def segments(spans):
    """[(start_us, end_us, name)]: the innermost span of one thread over
    time, from its (name, start_us, end_us), which nest."""
    out, stack, cursor = [], [], None
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            out.append((cursor, top[2], top[0]))
            cursor = top[2]
        if stack:
            out.append((cursor, s, stack[-1][0]))
        cursor = s
        stack.append((name, s, e))
    while stack:
        top = stack.pop()
        out.append((cursor, top[2], top[0]))
        cursor = top[2]
    return [x for x in out if x[1] > x[0]]


class Innermost:
    """The innermost span's name at a time on one thread (None outside)."""

    def __init__(self, spans):
        self.segs = segments(spans)
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None


class SpanTrace(Trace):
    """``Trace`` with the program's spans, {tid: [(name, start_us, end_us,
    args)]}, the device events' correlation ids, ``launched``: [(name,
    start_us, end_us, correlation)], and the runtime calls, ``calls``:
    {correlation: (name, start_us, end_us, tid)}."""

    def __init__(self, events: list):
        super().__init__(events)
        self.spans, self.launched, self.calls = {}, [], {}
        for e in events:
            if "dur" not in e or "ts" not in e:
                continue
            s = float(e["ts"])
            end = s + float(e["dur"])
            cat, args = e.get("cat"), e.get("args") or {}
            if cat == PROGRAM:
                self.spans.setdefault(e.get("tid"), []).append((e["name"], s, end, args))
            elif cat in DEVICE_CATS:
                self.launched.append((e["name"], s, end, args.get("correlation")))
            elif cat in RUNTIME and args.get("correlation") is not None:
                self.calls[args["correlation"]] = (e["name"], s, end, e.get("tid"))

    @staticmethod
    def load(path) -> "SpanTrace":
        with open(path) as f:
            return SpanTrace(json.load(f)["traceEvents"])

    def frames(self):
        """The loop's thread (the one with the most ``pipeline.frame`` spans)
        and the args of its frames."""
        per = {tid: [a for n, _, _, a in sp if n == "pipeline.frame"]
               for tid, sp in self.spans.items()}
        if not per:
            return None, []
        tid = max(per, key=lambda t: len(per[t]))
        return tid, per[tid]


def by_layer(trace: SpanTrace) -> dict:
    """The window put down to layers: {"busy_us", "idle_us": {layer or None:
    us}, "attributed_us", "program_us", "frame_us", "frame_attributed_us",
    "busy_us_total", "idle_us_total", "unattributed": [((kernel, span), us)],
    "unattributed_by_span": {span: us}, "idle_by_span_and_call":
    [((innermost span, host call), us)], "frames", "cadence_frames",
    "calls_on_span_threads"}; None where the trace holds no spans."""
    if not trace.spans:
        return None
    inner = {tid: Innermost([(n, s, e) for n, s, e, _ in sp])
             for tid, sp in trace.spans.items()}
    loop_tid, frames = trace.frames()
    if loop_tid is None:
        loop_tid = next(iter(inner))
    frame = Innermost([(n, s, e) for n, s, e, _ in trace.spans.get(loop_tid, [])
                       if n == "pipeline.frame"])
    busy, unattributed, program, in_frames = {}, Counter(), [], ([], [])
    on_threads = 0
    for name, s, e, corr in trace.launched:
        call = trace.calls.get(corr)
        tid = call[3] if call is not None else None
        layer = where = None
        if tid in inner:
            on_threads += 1
            mid = 0.5 * (call[1] + call[2])
            where = inner[tid].at(mid)
            layer = layer_of(where) if where else None
            if tid == loop_tid and frame.at(mid):
                in_frames[layer is not None].append((s, e))
        busy.setdefault(layer, []).append((s, e))
        if where is not None:
            program.append((s, e))
        if layer is None:
            unattributed[(name[:100], where or ("no span" if tid in inner
                                                else "unknown thread"))] += e - s
    by_span = Counter()
    for (_, where), us in unattributed.items():
        by_span[where] += us
    device = [(s, e) for _, s, e in trace.device]
    idle, by_call = {}, Counter()
    host = sorted(trace.host, key=lambda h: h[1])
    active, i = [], 0
    for gs, ge in gaps(device, *trace.window):
        mid = 0.5 * (gs + ge)
        where = inner[loop_tid].at(mid)
        layer = layer_of(where) if where else None
        idle[layer] = idle.get(layer, 0.0) + (ge - gs)
        # the innermost host call at the gap's middle, as Trace.idle_by_host
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        call = min(active, key=lambda h: h[2] - h[1], default=None)
        by_call[(where or "no span", call[0] if call else "(no host operation)")] += ge - gs
    return {"busy_us": {k: union_length(v) for k, v in busy.items()},
            "idle_us": idle,
            "attributed_us": union_length([x for k, v in busy.items() if k for x in v]),
            "program_us": union_length(program),
            "frame_us": union_length(in_frames[0] + in_frames[1]),
            "frame_attributed_us": union_length(in_frames[1]),
            "busy_us_total": union_length(device),
            "idle_us_total": sum(ge - gs for gs, ge in gaps(device, *trace.window)),
            "unattributed": unattributed.most_common(8),
            "unattributed_by_span": dict(by_span),
            "idle_by_span_and_call": by_call.most_common(12),
            "frames": len(frames),
            "cadence_frames": sum(1 for a in frames if a.get("cadence")),
            "calls_on_span_threads": (on_threads, len(trace.launched))}


def done_reads(trace: SpanTrace):
    """(spans, enclosing, median margin us) of the ``tracker.done_read``
    spans: those that enclose a ``cudaStreamSynchronize`` or
    ``cudaMemcpyAsync`` call of their thread."""
    calls = {}
    for n, s, e, tid in trace.calls.values():
        if n.startswith(("cudaStreamSynchronize", "cudaMemcpyAsync")):
            calls.setdefault(tid, []).append((s, e))
    for v in calls.values():
        v.sort()
    reads = [(tid, s, e) for tid, sp in trace.spans.items()
             for n, s, e, _ in sp if n == "tracker.done_read"]
    ok, margins = 0, []
    for tid, s, e in reads:
        cs = calls.get(tid, [])
        i = bisect.bisect_left(cs, (s, s))
        inside = [(c0, c1) for c0, c1 in cs[i:i + 4] if c0 >= s and c1 <= e]
        if inside:
            ok += 1
            margins.append(min(min(c0 - s for c0, _ in inside), min(e - c1 for _, c1 in inside)))
    margins.sort()
    return len(reads), ok, margins[len(margins) // 2] if margins else None


def summary(trace: SpanTrace) -> dict:
    """The split as plain numbers: busy and idle ms by layer ("unspanned",
    "unattributed" for None), in all and a frame (map and mesher: a cadence
    frame), the attributed share of all busy time and of the frames' work,
    the partition's check, the unattributed work by span and kernel and the
    done reads' enclosure."""
    got = by_layer(trace)
    if got is None:
        return {"spans": 0}
    frames, cad = got["frames"], got["cadence_frames"]

    def per_frame(layer, us):
        n = cad if layer in ("map", "mesher") else frames
        return 1e-3 * us / n if n else None

    return {
        "frames": frames, "cadence_frames": cad,
        "busy_ms": {k or "unattributed": 1e-3 * v for k, v in got["busy_us"].items()},
        "idle_ms": {k or "unspanned": 1e-3 * v for k, v in got["idle_us"].items()},
        "busy_ms_a_frame": {k: per_frame(k, v) for k, v in got["busy_us"].items() if k},
        "idle_ms_a_frame": {k or "unspanned": per_frame(k, v)
                            for k, v in got["idle_us"].items()},
        "attributed_share": got["attributed_us"] / got["busy_us_total"]
        if got["busy_us_total"] else None,
        "frames_attributed_share": got["frame_attributed_us"] / got["frame_us"]
        if got["frame_us"] else None,
        "idle_ms_total": 1e-3 * got["idle_us_total"],
        "idle_ms_partitioned": 1e-3 * sum(got["idle_us"].values()),
        "unattributed_ms_by_span": {k: 1e-3 * v for k, v in got["unattributed_by_span"].items()},
        "unattributed_us": [[list(k), v] for k, v in got["unattributed"]],
        "idle_us_by_span_and_call": [[list(k), v] for k, v in got["idle_by_span_and_call"]],
        "calls_on_span_threads": list(got["calls_on_span_threads"]),
        "done_reads": list(done_reads(trace))}


if __name__ == "__main__":
    print(json.dumps(summary(SpanTrace.load(sys.argv[1]))))
