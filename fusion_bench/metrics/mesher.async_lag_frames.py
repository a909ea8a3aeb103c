"""Median number of frames from an async mesh extraction's dispatch to the
``Mesher.extract`` call that returned its triangles, over the extractions
the window dispatched and saw returned (``harness.MeshReturns``): how old
the live mesh is when the user gets it."""

import statistics


def read(ctx):
    lag = ctx.get("mesh_lag")
    return statistics.median(lag) if lag else None
