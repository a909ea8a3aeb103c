"""Loss/timing aggregation meters (capability parity with utils/exp_util.py:115-256)."""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np


class AverageMeter:
    def __init__(self):
        self.loss_dict = OrderedDict()

    def append_loss(self, losses: dict):
        for name, val in losses.items():
            if val is None:
                continue
            val = float(val)
            if np.isnan(val):
                continue
            self.loss_dict.setdefault(name, []).append(val)

    def get_mean_loss_dict(self):
        return {name: float(np.mean(arr)) for name, arr in self.loss_dict.items()}

    def get_mean_loss(self):
        means = self.get_mean_loss_dict()
        if not means:
            return 0.0
        return sum(means.values()) / len(means)

    def get_printable_mean(self):
        means = self.get_mean_loss_dict()
        text = " ".join(f"({k}:{v:.4f})" for k, v in means.items())
        return text + f" sum = {sum(means.values()):.4f}"


class RunningAverageMeter:
    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha
        self.loss_dict = OrderedDict()

    def append_loss(self, losses: dict):
        for name, val in losses.items():
            if val is None:
                continue
            val = float(val)
            if np.isnan(val):
                continue
            if name not in self.loss_dict:
                self.loss_dict[name] = val
            else:
                self.loss_dict[name] = self.alpha * self.loss_dict[name] + (1 - self.alpha) * val

    def get_loss_dict(self):
        return dict(self.loss_dict)


class StageTimer:
    """Per-stage wall-clock timer for the fusion loop (track/integrate/mesh).

    The reference has no per-stage instrumentation (SURVEY.md §5.1); the
    ≥10fps target requires it, so it's first-class here.
    """

    def __init__(self):
        self.totals = OrderedDict()
        self.counts = OrderedDict()
        self.maxes = OrderedDict()
        self._start = {}

    def start(self, stage: str):
        self._start[stage] = time.perf_counter()

    def stop(self, stage: str):
        dt = time.perf_counter() - self._start.pop(stage)
        self.totals[stage] = self.totals.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1
        self.maxes[stage] = max(self.maxes.get(stage, 0.0), dt)
        return dt

    class _Scope:
        def __init__(self, timer, stage):
            self.timer, self.stage = timer, stage

        def __enter__(self):
            self.timer.start(self.stage)

        def __exit__(self, *exc):
            self.timer.stop(self.stage)

    def scope(self, stage: str):
        return self._Scope(self, stage)

    def summary(self) -> dict:
        return {
            stage: {"total_s": self.totals[stage], "count": self.counts[stage],
                    "mean_ms": 1e3 * self.totals[stage] / max(self.counts[stage], 1),
                    "max_ms": 1e3 * self.maxes.get(stage, 0.0)}
            for stage in self.totals
        }
