"""``photometric_hg``: the photometric term's normal equations at one level.

Per evaluated pixel the warp (24 operations; a valid pixel's Jacobian,
weight and sums, 96 more, depend on the data and are left out).  Bytes: the
current level's planes at each evaluated pixel (intensity, depth, two
gradients: 16 bytes dense; a selected pixel's 6 floats and its flag: 25
bytes), the ``touched`` source rows the warp reads (8 bytes each; no counter
gives them, so 0 by default and the bound is a lower one), the pose in and
the 44 sums out.
"""

from fusion_bench.rooflines import PEAK_F32

OPS_PIXEL = 24


def work(pixels: int, sparse: bool = False, touched: int = 0):
    per_pixel = 25 if sparse else 16
    return (pixels * OPS_PIXEL, pixels * per_pixel + touched * 8.0 + 12 * 4 + 44 * 4, PEAK_F32)
