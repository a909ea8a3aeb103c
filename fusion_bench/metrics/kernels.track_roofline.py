"""The tracking kernels' least time over their traced time, in percent:
``decoder_forward_grad``, ``sdf_rows``, ``sdf_hg``, ``photometric_hg``,
``select_gather``, ``stencil_frontend``, ``gn_step``
(``fusion_bench.kernels``)."""

from fusion_bench.kernels import roofline_share


def read(ctx):
    return roofline_share(ctx, ("decoder_forward_grad", "sdf_rows", "sdf_hg", "photometric_hg",
                                "select_gather", "stencil_frontend", "gn_step"))
