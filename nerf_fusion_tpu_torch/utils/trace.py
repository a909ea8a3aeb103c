"""Spans and counters of the fusion loop, recorded where the work happens.

    from nerf_fusion_tpu_torch.utils import trace

    with trace.span("tracker.eval"):          # around the host code of a layer
        graph.replay()
    trace.count("mesher.extractions")
    with trace.capture() as cap:              # records what runs inside
        pipeline.process_frame(frame, frame_id)
    cap.export()    # {"spans", "counters", "anchors", "anchor_event", ...}

Off (no capture open, the default): ``span`` returns the one shared no-op
object, ``NOOP``, without reading a clock, allocating or locking, and
``count`` tests a flag.  On: a span is a record in memory until the capture
closes: its name, start and end in ``time.perf_counter_ns()``, the native
id of its thread, its own id, its parent's id (the span open around it on
its thread, or ``parent`` where it is handed in: a worker's job names the
span that submitted it) and the frame id, which ``pipeline.frame`` sets and
every span under it inherits.  Counters are host ints.
``capture(summary=names)`` keeps only the count, total and longest span of
each of ``names`` (``FusionPipeline.run``'s ``stats.json`` timing); a span
of another name is ``NOOP`` there.

A span reads the host's clock: one around a kernel launch or a graph replay
ends when the launch returns, one around a host read when the device got
there.  A capture that records spans lets a reader put them on a
``torch.profiler`` trace's clock: at its start and at its end it brackets
one call that such a trace records (``cudaEventSynchronize`` once CUDA is
initialised, else a ``record_function`` named ``ANCHOR``) between two
stamps, and ``clock_map`` fits the line from those stamps to the two events
(``to_chrome`` writes the spans onto a trace that way).
"""

from __future__ import annotations

import itertools
import json
import threading
import time

ANCHOR = "trace.anchor"
_ns = time.perf_counter_ns
_cap = None                    # the open Capture, or None
_ids = itertools.count(1)
_local = threading.local()     # .stack: the open spans of this thread; .tid


class _NoOp:
    """What ``span`` returns while no capture is open."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoOp()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.tid = threading.get_native_id()
        return _local.stack


class Span:
    __slots__ = ("cap", "name", "start", "end", "tid", "id", "parent", "frame", "attrs",
                 "_cause")

    def __init__(self, cap, name, frame, parent, attrs):
        self.cap, self.name, self.frame, self._cause, self.attrs = \
            cap, name, frame, parent, attrs
        self.id = next(_ids)

    def __enter__(self):
        st = _stack()
        up = self._cause if self._cause is not None else (st[-1] if st else None)
        self.parent = up.id if up is not None else None
        if self.frame is None and up is not None:
            self.frame = up.frame
        self.tid = _local.tid
        st.append(self)
        self.start = _ns()
        return self

    def __exit__(self, *exc):
        self.end = _ns()
        st = _local.stack
        if st[-1] is self:
            st.pop()
        else:
            st.remove(self)
        self._cause = None
        if self.cap is _cap:
            self.cap._add(self)
        return False

    @property
    def ms(self) -> float:
        return 1e-6 * (self.end - self.start)


def span(name: str, frame=None, parent=None, attrs=None):
    """A context manager that records ``name`` while a capture is open;
    ``frame``: the frame id (else the parent's), ``parent``: the causing
    span (else the one open on this thread), ``attrs``: a dict the record
    keeps (never changed)."""
    cap = _cap
    if cap is None or (cap.summary is not None and name not in cap.summary):
        return NOOP
    return Span(cap, name, frame, parent, attrs)


def count(name: str, n: int = 1):
    cap = _cap
    if cap is not None:
        with cap._lock:        # the async worker counts beside the loop
            cap.counters[name] = cap.counters.get(name, 0) + n


def active():
    """The open capture, or None."""
    return _cap


def current():
    """The innermost span open on this thread, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


class Capture:
    """One recording; open it with ``with`` (one at a time in a process).
    ``summary``: None records every span, anchored to the profiler's clock;
    a collection of names keeps the totals of those names alone."""

    def __init__(self, summary=None):
        self.summary = None if summary is None else frozenset(summary)
        self.spans = []                # Span records (not with summary)
        self.counters = {}
        self.anchors = []              # [(ns before, ns after)] of each anchor call
        self.anchor_event = None
        self.anchor_tid = None         # the native id of the thread that made them
        self._totals = {}              # summary: name -> [count, total ns, longest ns]
        self._lock = threading.Lock()

    def __enter__(self):
        global _cap
        if _cap is not None:
            raise RuntimeError("a trace capture is already open")
        if self.summary is None:
            self._anchor()
        _cap = self
        return self

    def __exit__(self, *exc):
        global _cap
        _cap = None
        if self.summary is None:
            self._anchor()
        return False

    def _anchor(self):
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ev = torch.cuda.Event()
            ev.record()
            t0 = _ns()
            ev.synchronize()
            t1 = _ns()
            self.anchor_event = "cudaEventSynchronize"
        else:
            # a first call of another name: the first one under a profiler
            # takes a millisecond, the second some microseconds
            with torch.profiler.record_function(ANCHOR + ".warm"):
                pass
            rf = torch.profiler.record_function(ANCHOR)
            t0 = _ns()
            with rf:
                pass
            t1 = _ns()
            self.anchor_event = ANCHOR
        self.anchors.append((t0, t1))
        self.anchor_tid = threading.get_native_id()

    def _add(self, s: Span):
        if self.summary is None:
            self.spans.append(s)
            return
        d = s.end - s.start
        with self._lock:
            t = self._totals.get(s.name)
            if t is None:
                self._totals[s.name] = [1, d, d]
            else:
                t[0] += 1
                t[1] += d
                t[2] = max(t[2], d)

    def totals(self) -> dict:
        """{name: (count, total ns, longest ns)} of the spans closed so far."""
        if self.summary is not None:
            with self._lock:
                return {k: tuple(v) for k, v in self._totals.items()}
        out = {}
        for s in list(self.spans):
            c, tot, mx = out.get(s.name, (0, 0, 0))
            out[s.name] = (c + 1, tot + s.end - s.start, max(mx, s.end - s.start))
        return out

    def export(self) -> dict:
        """The recording as plain data: spans as dicts (name, start_ns,
        end_ns, tid, id, parent, frame, attrs), counters, and the anchors
        with their event's name and the native id of their thread."""
        return {"spans": [{"name": s.name, "start_ns": s.start, "end_ns": s.end,
                           "tid": s.tid, "id": s.id, "parent": s.parent, "frame": s.frame,
                           "attrs": s.attrs or {}} for s in self.spans],
                "counters": dict(self.counters), "anchors": list(self.anchors),
                "anchor_event": self.anchor_event, "anchor_tid": self.anchor_tid}


capture = Capture


def clock_map(anchors, events):
    """(a, b) with trace_us = a + b * perf_counter_ns, from the capture's
    anchor stamps and its anchor events in the trace, [(ts_us, dur_us)] in
    time order: the midpoints of the first and the last pair (one pair:
    the slope of two clocks that both count time)."""
    if not anchors or not events:
        raise ValueError("the trace holds no anchor event of the capture")
    (p0, p1), (e0, d0) = anchors[0], events[0]
    x0, y0 = 0.5 * (p0 + p1), e0 + 0.5 * d0
    b = 1e-3
    if len(anchors) > 1 and len(events) > 1:
        (p2, p3), (e2, d2) = anchors[-1], events[-1]
        x1, y1 = 0.5 * (p2 + p3), e2 + 0.5 * d2
        if x1 > x0:
            b = (y1 - y0) / (x1 - x0)
    return y0 - b * x0, b


def to_chrome(recording: dict, path):
    """Add the spans of ``recording`` (``Capture.export()``, with anchors) to
    the chrome trace at ``path`` as complete events of category
    ``program_span`` on the trace's clock.  The anchors' thread takes the
    id that the trace gives their events; other threads keep their native
    id."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    name = recording["anchor_event"]
    found = sorted((float(e["ts"]), float(e.get("dur", 0)), e.get("tid")) for e in events
                   if e.get("name") == name and "ts" in e)
    a, b = clock_map(recording["anchors"], [f[:2] for f in found])
    tids = {recording["anchor_tid"]: found[0][2]}
    pid = next((e["pid"] for e in events if e.get("cat") == "cpu_op" or
                e.get("cat") == "cuda_runtime"), 0)
    for s in recording["spans"]:
        args = {"id": s["id"], "parent": s["parent"], "frame": s["frame"]}
        args.update({k: v if isinstance(v, (int, float, str, bool)) else str(v)
                     for k, v in s["attrs"].items()})
        events.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid,
                       "tid": tids.get(s["tid"], s["tid"]), "ts": a + b * s["start_ns"],
                       "dur": b * (s["end_ns"] - s["start_ns"]), "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
