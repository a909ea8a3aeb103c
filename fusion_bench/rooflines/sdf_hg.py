"""``sdf_hg``: the SDF term's residual, Jacobian, robust weight and the 6x6
reduction, one row a point (about 120 operations); bytes: the decoder's
output and gradient, the moved point and the use flag in (8 + 12 + 12 + 1),
the 44 sums out."""

from fusion_bench.rooflines import PEAK_F32

OPS_ROW = 120


def work(rows: int):
    return rows * float(OPS_ROW), rows * 33.0 + 44 * 4, PEAK_F32
