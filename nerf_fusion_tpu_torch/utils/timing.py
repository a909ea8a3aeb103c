"""Timing of one GPU call: its device time and its call time.

``device_ms`` sums the durations of the kernels (and copies) that ``reps``
calls run on the card, from a ``torch.profiler`` trace, and divides by
``reps``: the time the card works for one call.  ``call_ms`` is the wall
time of ``reps`` back-to-back calls between two CUDA events, per call: it
also holds the host's cost of issuing the call, and for a call whose
kernels are shorter than that cost it measures the host, not the card.
Both run the call 3 times first.
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _warm(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 20) -> float:
    """The profiler now and then returns a trace without the device's events
    (once in a ``chip_smoke.py`` run on the H100, for ``torch.gather``); such
    a trace is taken again, at most three times in all."""
    _warm(fn)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            return busy_us * 1e-3 / reps
    raise RuntimeError("device_ms: three traces held no device time")


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
