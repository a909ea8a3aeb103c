"""Latent refinements dispatched in the window over its integrate-and-mesh
frames (the entries the window added to ``SparseVoxelMap.refine_log``, one
a dispatch): 1 where every cadence refines; under ``run_async`` less, each
cadence that found the worker's refinement still running having skipped
its own."""


def read(ctx):
    n = sum(1 for f in ctx["frame_ids"] if f % ctx["cadence"] == 0)
    return ctx["refine"]["count"] / n if n else None
