"""Median device time (ms) of one latent refinement over the window's
refinements: the program's own CUDA events around each (``StageClock`` in
``SparseVoxelMap.refine_log``), read after the window."""

import statistics


def read(ctx):
    ms = ctx["refine"]["ms"]
    return statistics.median(ms) if ms else None
