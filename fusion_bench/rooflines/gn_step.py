"""``gn_step``: one Gauss-Newton step on one thread: the 6x6 solve, the
exponential map and the composition (about 600 operations); 280 bytes in,
113 out."""

from fusion_bench.rooflines import PEAK_F32


def work():
    return 600.0, 280.0 + 113.0, PEAK_F32
