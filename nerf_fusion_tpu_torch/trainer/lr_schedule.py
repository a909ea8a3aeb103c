"""Learning-rate schedules built from config dicts (counterpart of the JAX package's trainer/lr_schedule.py)."""

from __future__ import annotations


class ConstantSchedule:
    def __init__(self, value):
        self.value = value

    def get_learning_rate(self, epoch):
        return self.value


class StepSchedule:
    def __init__(self, initial, interval, factor):
        self.initial, self.interval, self.factor = initial, interval, factor

    def get_learning_rate(self, epoch):
        return self.initial * (self.factor ** (epoch // self.interval))


class WarmupSchedule:
    def __init__(self, initial, warmed_up, length):
        self.initial, self.warmed_up, self.length = initial, warmed_up, length

    def get_learning_rate(self, epoch):
        if epoch > self.length:
            return self.warmed_up
        return self.initial + (self.warmed_up - self.initial) * epoch / self.length


def get_learning_rate_schedules(args):
    out = []
    for spec in args.lr_schedule:
        kind = spec["Type"]
        if kind == "Step":
            out.append(StepSchedule(spec["Initial"], spec["Interval"], spec["Factor"]))
        elif kind == "Warmup":
            out.append(WarmupSchedule(spec["Initial"], spec["Final"], spec["Length"]))
        elif kind == "Constant":
            out.append(ConstantSchedule(spec["Value"]))
        else:
            raise ValueError(f"unknown lr schedule type {kind}")
    return out
