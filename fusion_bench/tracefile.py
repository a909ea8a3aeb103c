"""Reading a ``torch.profiler`` chrome trace: device work, its busy time and
the host's activity in the device's idle gaps.

The profiler runs over the traced frames alone, synchronised at both ends,
so the trace's span, from its first event to its last, is the traced
window.  Device events are kernels, copies and memsets on any
stream; busy time is the union of their intervals, so work that overlaps on
two streams counts once; each event's stream is kept, so that the work of
one stream can be held against the others'.  Host events are the CUDA runtime and driver calls
(and operators, where the trace has them).
"""

from __future__ import annotations

import json

from .arith import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    """``device``, ``host``: [(name, start_us, end_us)]; ``streams``: each
    device event's stream (the event's ``stream`` argument, else its
    ``tid``), in ``device``'s order; ``window``: the trace's span (start_us,
    end_us); ``window_s``: its length."""

    def __init__(self, events: list):
        self.device, self.host, self.streams = [], [], []
        for e in events:
            if "dur" not in e or "ts" not in e:
                continue
            s = float(e["ts"])
            span = (e["name"], s, s + float(e["dur"]))
            if e.get("cat") in DEVICE_CATS:
                self.device.append(span)
                self.streams.append((e.get("args") or {}).get("stream", e.get("tid")))
            elif e.get("cat") in HOST_CATS:
                self.host.append(span)
        spans = self.device + self.host
        self.window = (min(s for _, s, _ in spans), max(e for _, _, e in spans)) \
            if spans else (0.0, 0.0)

    @staticmethod
    def load(path) -> "Trace":
        with open(path) as f:
            return Trace(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device]) * 1e-6

    @property
    def first_stream(self):
        """The stream of the earliest device event (None without one)."""
        if not self.device:
            return None
        return self.streams[min(range(len(self.device)), key=lambda i: self.device[i][1])]

    def overlap_share(self, main):
        """The share of the device time of the streams other than ``main``
        (the union of their events) that overlaps device work on ``main``;
        None where they ran nothing."""
        other = [(s, e) for (_, s, e), st in zip(self.device, self.streams) if st != main]
        mine = [(s, e) for (_, s, e), st in zip(self.device, self.streams) if st == main]
        theirs = union_length(other)
        if theirs <= 0:
            return None
        return (theirs + union_length(mine) - union_length(other + mine)) / theirs

    def top_device_ops(self, n: int = 10) -> list:
        total = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s) * 1e-6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """Idle seconds of the device inside the window, summed by the
        innermost host operation running at each gap's middle."""
        host = sorted(self.host, key=lambda h: h[1])
        total = {}
        active, i = [], 0
        for gs, ge in gaps([(s, e) for _, s, e in self.device], *self.window):
            mid = 0.5 * (gs + ge)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            best = min(active, key=lambda h: h[2] - h[1], default=None)
            key = best[0] if best else "(no host operation)"
            total[key] = total.get(key, 0.0) + (ge - gs) * 1e-6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
