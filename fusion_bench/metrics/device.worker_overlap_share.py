"""The share of the worker streams' device time in the traced cycles that
overlaps device work on the loop's stream (``tracefile.Trace.
overlap_share``).  The loop's stream is the one of the trace's first
device event: the traced frames start with a cadence frame, whose tracking
runs on the loop's stream before it dispatches the worker's jobs, and the
harness has waited for the earlier jobs."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "trace" not in tr:
        return None
    trace = tr["trace"]
    return trace.overlap_share(trace.first_stream)
