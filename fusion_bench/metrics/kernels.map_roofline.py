"""The map's and the mesher's MLP kernels' least time over their traced
time, in percent: ``encoder_forward``, ``decoder_forward``."""

from fusion_bench.kernels import roofline_share


def read(ctx):
    return roofline_share(ctx, ("encoder_forward", "decoder_forward"))
