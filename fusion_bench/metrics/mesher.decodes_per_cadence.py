"""Decoder calls of the mesher a cadence frame over the window:
``decoder_forward`` launches / integrate-and-mesh frames."""


def read(ctx):
    n = sum(1 for f in ctx["frame_ids"] if f % ctx["cadence"] == 0)
    return ctx["launches"]["decoder_forward"] / n if n else None
