"""Read-ahead frame decoding for disk-backed sequences.

Counterpart of the JAX package's ``data/prefetch.py``.  OpenCV's PNG
decoder releases the interpreter lock, so a small thread pool overlaps the
decode with the device's work on the frames before.

Two modes:
- sequences with ``load_frame(idx)`` (random access, thread-safe) decode
  up to ``depth`` frames ahead across ``workers`` threads;
- iterator-only sequences fall back to one worker calling ``next(base)``
  in order.

``upload=True`` also puts each frame's rgb and depth on the GPU: a copy
into pinned host memory, then a ``non_blocking`` copy on a side CUDA
stream with an event recorded after it.  The copies are issued from the
consumer's thread, for every decoded frame in the read-ahead queue, when
it takes a frame (the worker threads make no CUDA call, so they cannot
disturb a CUDA-graph capture on the consumer's stream).  Before a frame
is handed out, the consumer's current stream waits on its event and its
tensors are recorded on that stream, so the allocator does not reuse
their memory while the consumer's work is still queued.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .base import FrameData

_END = object()  # the base iterator is exhausted (fallback mode)


class PrefetchSequence:
    """Wraps an RGBDSequence; iteration order and frame contents are those
    of direct iteration."""

    def __init__(self, base, depth: int = 4, workers: int = 2,
                 upload: bool = False, device="cuda"):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._base = base
        self._depth = depth
        self._device = torch.device(device)
        self._upload = bool(upload)
        if self._upload and self._device.type != "cuda":
            raise ValueError(f"upload=True needs a CUDA device, got {self._device}")
        self._stream = torch.cuda.Stream(self._device) if self._upload else None
        self._random_access = hasattr(base, "load_frame")
        # iterator-only sequences advance their state in __next__: one
        # worker keeps those calls in order
        self._pool = ThreadPoolExecutor(
            max_workers=workers if self._random_access else 1,
            thread_name_prefix="prefetch")
        self._pending = deque()        # [future, uploaded frame or None, event]
        self._next_submit = 0
        self._fill()

    # -- passthrough ------------------------------------------------------
    def __len__(self):
        return len(self._base)

    def __getattr__(self, name):
        # gt_trajectory, calib, scene_sdf, ... resolve on the wrapped reader
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._base, name)

    # -- iteration --------------------------------------------------------
    def __iter__(self):
        return self

    def _fetch_next_inorder(self):
        try:
            return next(self._base)
        except StopIteration:
            return _END

    def _fill(self):
        while len(self._pending) < self._depth:
            if self._random_access:
                if self._next_submit >= len(self._base):
                    break
                fut = self._pool.submit(self._base.load_frame, self._next_submit)
            else:
                fut = self._pool.submit(self._fetch_next_inorder)
            self._next_submit += 1
            self._pending.append([fut, None, None])

    def _start_upload(self, entry):
        """Issue the host -> device copies of a decoded frame on the side
        stream; the frame's arrays are replaced by the device tensors."""
        frame = entry[0].result()
        if frame is _END:
            entry[1] = _END
            return
        with torch.cuda.stream(self._stream):
            for name in ("rgb", "depth"):
                a = getattr(frame, name)
                host = torch.from_numpy(np.ascontiguousarray(a)) \
                    if isinstance(a, np.ndarray) else a
                if host.device.type == "cpu":
                    host = host.pin_memory()
                setattr(frame, name, host.to(self._device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        entry[1], entry[2] = frame, event

    def __next__(self) -> FrameData:
        if not self._pending:
            raise StopIteration
        if not self._upload:
            frame = self._pending.popleft()[0].result()
        else:
            head = self._pending[0]
            if head[1] is None:
                self._start_upload(head)
            # read ahead: the decoded frames behind the head go up now, on
            # the side stream, while the consumer works on this one
            for entry in list(self._pending)[1:]:
                if entry[1] is None and entry[0].done():
                    self._start_upload(entry)
            _, frame, event = self._pending.popleft()
            if frame is not _END:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(event)
                frame.rgb.record_stream(consumer)
                frame.depth.record_stream(consumer)
        self._fill()
        if frame is _END:
            raise StopIteration
        return frame

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
