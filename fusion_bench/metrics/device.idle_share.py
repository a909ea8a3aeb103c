"""1 - (the device's busy time a traced frame) / (the untraced frames' mean
interval).  Busy time is the union of the device's event intervals in the
traced cycles.  The profiler slows the host, which paces these frames, so
the traced window's own idle share (``device.window_s``) reads high; the
untraced frames hold the same mix of frames at the run's own pace."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "trace" not in tr or not tr["frames"]:
        return None
    ms = [m for m, t in zip(ctx["interval_ms"], ctx["traced"]) if not t]
    if not ms or sum(ms) <= 0:
        return None
    busy = tr["trace"].busy_s / len(tr["frames"])
    return 1.0 - busy / (1e-3 * sum(ms) / len(ms))
