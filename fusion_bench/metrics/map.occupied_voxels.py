"""Allocated voxels of the map at the window's end (``n_occupied``): the
work the integration and the mesher scale with."""


def read(ctx):
    return ctx["occupied_voxels"]
