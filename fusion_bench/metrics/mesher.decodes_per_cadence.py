"""Decoder calls of the mesher a cadence frame over the window:
(``decoder_forward`` launches less the latent refinements' forward calls,
``n_iters`` a refinement) / integrate-and-mesh frames."""


def read(ctx):
    n = sum(1 for f in ctx["frame_ids"] if f % ctx["cadence"] == 0)
    refine_calls = ctx["refine"]["count"] * ctx["refine"]["n_iters"]
    return (ctx["launches"]["decoder_forward"] - refine_calls) / n if n else None
