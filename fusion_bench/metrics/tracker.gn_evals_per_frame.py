"""GN evaluations a frame over the window: ``gn_step`` launches / frames."""


def read(ctx):
    n = len(ctx["frame_ids"])
    return ctx["launches"]["gn_step"] / n if n else None
