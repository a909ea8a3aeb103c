"""The tracker's host reads of the GN done flag a frame over the window
(``SDFTracker.host_reads``)."""


def read(ctx):
    n = len(ctx["frame_ids"])
    return ctx["host_reads"] / n if n else None
