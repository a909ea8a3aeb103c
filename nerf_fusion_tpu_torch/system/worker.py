"""The fusion loop's background worker: one thread and, on the card, one
CUDA stream, shared by the async mesher and the async refiner.

The JAX package runs its async mesher and refiner on an auxiliary device.
The port runs both on one card, and a job holds ``launches.EXCLUSIVE`` for
its whole length (no graph capture may diff the launch counters while a
worker launches), so two workers could never run at once: one worker
takes both kinds of job, in the order they were submitted.

Each job is a ``worker.job`` span (``utils/trace.py``) on the worker's
thread, from its start to the end of its stream's work (for a mesh job,
the mesh is complete then), whose parent is the span that submitted it.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import torch

from ..ops import launches
from ..utils import trace


class Worker:
    """``submit(fn, ...)`` records an event on the caller's stream and
    queues ``fn``; the worker thread runs it on the worker's stream after
    that event, holding ``launches.EXCLUSIVE``, and synchronises that
    stream before the future completes: what the job read is free, and what
    it wrote is ready, once the future is done.  The thread starts with the
    first job; the interpreter runs every queued job before it exits."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._pool = None

    def submit(self, fn, *args, **kwargs) -> Future:
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record()

        cause = trace.current()

        def job():
            with trace.span("worker.job", parent=cause,
                            attrs={"job": getattr(fn, "__qualname__", "")}), launches.EXCLUSIVE:
                if self.stream is None:
                    return fn(*args, **kwargs)
                with torch.cuda.stream(self.stream):
                    self.stream.wait_event(ready)
                    out = fn(*args, **kwargs)
                self.stream.synchronize()
                return out

        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fusion-worker")
        return self._pool.submit(job)
