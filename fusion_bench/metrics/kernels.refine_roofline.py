"""The latent refinement's VJP kernel, ``decoder_vjp``: its least time over
its traced time, in percent.  Its work is the corner pairs that count (a
valid point at an eligible voxel) in each Adam step; the kernel computes
every pair of the cloud, so where few voxels are eligible the share reads
low."""

from fusion_bench.kernels import roofline_share


def read(ctx):
    return roofline_share(ctx, ("decoder_vjp",))
