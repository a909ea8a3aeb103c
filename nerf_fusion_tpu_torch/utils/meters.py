"""Loss aggregation meters (capability parity with utils/exp_util.py:115-256); the
fusion loop's timing is its spans (``utils/trace.py``)."""

from __future__ import annotations

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
