"""The prior's model FLOPs of the traced integrate-and-mesh frames over the
time such a frame takes at the run's own pace (the untraced cadence
frames' mean interval, once for each traced one), times the H100's dense
TF32 peak, in percent."""

from fusion_bench.kernels import mlp_flops, peak_share


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "trace" not in tr:
        return None
    ms = [m for f, m, t in zip(ctx["frame_ids"], ctx["interval_ms"], ctx["traced"])
          if f % ctx["cadence"] == 0 and not t]
    idx = [i for i, f in enumerate(tr["frames"]) if f % ctx["cadence"] == 0]
    flops = mlp_flops(ctx, idx) if idx else None
    if not ms or not flops:
        return None
    return peak_share(flops, 1e-3 * sum(ms) / len(ms) * len(idx))
