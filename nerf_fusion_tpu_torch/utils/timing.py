"""Timing of one GPU call: its device time and its call time.

``device_ms`` sums the durations of the kernels (and copies) that ``reps``
calls run on the card, from a ``torch.profiler`` trace, and divides by
``reps``: the time the card works for one call.  ``call_ms`` is the wall
time of ``reps`` back-to-back calls between two CUDA events, per call: it
also holds the host's cost of issuing the call, and for a call whose
kernels are shorter than that cost it measures the host, not the card.
Both run the call 3 times first.  ``device_trace`` lists the device events
of such a trace one by one, with each kernel's grid and block, and
``per_call`` turns event durations into time and events per call, also for
a trace that lost events.  ``l2_flush`` gives a ``flush`` for ``device_ms``:
a device-to-device copy larger than the H100's 50 MB L2 before each call,
so that the call finds its operands in device memory, not in the cache;
the copy's own events are left out of the time (a flush names the events
it launches in ``events``; ``tools/gather_probe.py`` has one that only
reads, which leaves no dirty line behind).
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _warm(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()


def per_call(durations_us, reps: int):
    """(device ms, device events) per call from the durations of the device
    events that a trace of ``reps`` calls holds.  A trace can lose device
    events, in the runs seen its first ones (87 and 97 events for 100
    launches of one kernel): a count that is no multiple of ``reps`` is
    read as such a trace, and the time is then the mean event's times the
    next whole number of events a call (exact while fewer than ``reps``
    events are lost), not the sum over ``reps``."""
    n = len(durations_us)
    k = -(-n // reps)
    total = float(sum(durations_us))
    return (total / reps if n % reps == 0 else total / n * k) * 1e-3, k


FLUSH_EVENT = "Memcpy DtoD"


def l2_flush(device, nbytes: int = 128 << 20):
    """A call that evicts the L2: one copy of ``nbytes`` (two buffers of that
    size stay allocated while the returned function lives)."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

    flush.events = (FLUSH_EVENT,)
    return flush


def device_ms(fn, reps: int = 20, flush=None) -> float:
    """The profiler now and then returns a trace without the device's events
    (once in a ``chip_smoke.py`` run on the H100, for ``torch.gather``); such
    a trace is taken again, at most three times in all.  ``flush``: called
    before each call (``l2_flush``); its events (``flush.events``: prefixes
    of their names) are not counted."""
    skip = tuple(flush.events) if flush is not None else ()
    _warm(fn)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        durations = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not (skip and e.name.startswith(skip))]
        if sum(durations) > 0:
            return per_call(durations, reps)[0]
    raise RuntimeError("device_ms: three traces held no device time")


def device_trace(fn, reps: int = 20) -> list:
    """One dict per device event of ``reps`` calls, from the chrome trace:
    name, duration in us, grid and block (None for a copy).  A trace
    without device events is taken again, at most three times in all, as
    in ``device_ms``."""
    _warm(fn)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        out = [{"name": e["name"], "us": float(e["dur"]), "grid": e["args"].get("grid"),
                "block": e["args"].get("block")}
               for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if out:
            return out
    raise RuntimeError("device_trace: three traces held no device events")


def call_ms(fn, reps: int = 20) -> float:
    _warm(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
