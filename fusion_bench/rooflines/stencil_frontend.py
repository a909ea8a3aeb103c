"""``stencil_frontend``: the frontend's point-cloud stage on one depth plane
of ``pixels`` pixels: the back-projection (6 operations a pixel); one depth
plane in, seven planes out (points, normals, mask).  The windowed counts and
covariances (49 taps of 8, and of 8 + 100, operations on each valid pixel)
depend on the data and no counter gives them: left out, so the bound is a
lower one."""

from fusion_bench.rooflines import PEAK_F32


def work(pixels: int):
    return pixels * 6.0, pixels * (4 + 25.0), PEAK_F32
