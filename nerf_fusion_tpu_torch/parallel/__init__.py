"""Data parallelism over several cards: not ported yet.

The JAX package shards each batch over a device mesh (``parallel/mesh.py``,
``parallel/distributed.py``); the port's counterpart is PyTorch DDP, a
later slice (ROADMAP.md, queue 1, item 10).  Until then asking for it raises.
"""

from __future__ import annotations


def data_parallel(n_devices: int):
    raise NotImplementedError(
        f"data parallelism over {n_devices} devices (--dp) is not ported yet: "
        "DDP is a later slice of the port (ROADMAP.md, queue 1, item 10)")
