"""The prior's model FLOPs of the traced frames (the decoder and encoder
rows the inputs need, each counted once at the published widths) over the
time those frames take at the run's own pace, times the H100's dense TF32
peak, in percent.  The profiler slows the host, which paces these frames,
so the time is the untraced frames' mean interval times the traced frames:
the traced cycles hold the window's mix of frames."""

from fusion_bench.kernels import mlp_flops, peak_share


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "trace" not in tr or not tr["frames"]:
        return None
    ms = [m for m, t in zip(ctx["interval_ms"], ctx["traced"]) if not t]
    flops = mlp_flops(ctx, range(len(tr["frames"])))
    if not ms or not flops:
        return None
    return peak_share(flops, 1e-3 * sum(ms) / len(ms) * len(tr["frames"]))
