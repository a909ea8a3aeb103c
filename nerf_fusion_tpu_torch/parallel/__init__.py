"""Data parallelism: one process per device in a ``torch.distributed`` group.

Counterpart of the JAX package's ``parallel/mesh.py`` (the ``dp`` axis:
``shard_batch``) and ``parallel/distributed.py`` (``maybe_initialize``,
``shard_host_batch``).  JAX shards one logical batch over a device mesh;
here every rank draws the same global batch from the same seed and keeps
its contiguous ``batch_size / world`` rows (``shard``), the networks are
wrapped in ``DistributedDataParallel`` (gradients averaged over the ranks)
and the encoder's BatchNorm all-reduces its statistics
(``models.encoder.TrainEncoder``), so a step equals the single-process
step on the whole batch.

``launch`` starts the ranks: NCCL on ``cuda:<rank>``, gloo on the CPU,
the group's address ``tcp://localhost:<free port>``; world size 1 runs in
the calling process.  Under ``torchrun`` (``WORLD_SIZE`` in the
environment) the process joins that group instead.  The ``tp`` layout of
the JAX package (``shard_decoder_params``) is ``parallel.tp``.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:<local_rank>``, or the CPU."""
    if device.type != "cuda":
        return device
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} needs a CUDA device; "
                           f"{torch.cuda.device_count()} available")
    return torch.device("cuda", local_rank)


def torchrun_world() -> int:
    """The world size a launcher such as ``torchrun`` set, else 0."""
    return int(os.environ.get("WORLD_SIZE", 0))


def _join(fn, dev: torch.device, args, **group):
    """Join the group, run ``fn(dev, *args)``, leave."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend(dev), timeout=TIMEOUT,
                            device_id=dev if dev.type == "cuda" else None, **group)
    try:
        return fn(dev, *args)
    finally:
        dist.destroy_process_group()


def _run_rank(rank: int, fn, world: int, address: str, device: torch.device, args):
    return _join(fn, rank_device(device, rank), args, init_method=address,
                 world_size=world, rank=rank)


def launch(fn, world: int, device, args=()):
    """``fn(rank_device, *args)`` on ``world`` ranks joined in one group;
    ``fn`` must be a module-level function (the ranks are ``spawn``
    processes, which import it).  World size 1 runs in this process and
    returns ``fn``'s result; else None.  Under ``torchrun`` this process
    is one rank of the launcher's group."""
    device = torch.device(device)
    if torchrun_world():
        if world != torchrun_world():
            raise ValueError(f"data-parallel degree {world} under a launcher with "
                             f"WORLD_SIZE {torchrun_world()}")
        return _join(fn, rank_device(device, int(os.environ.get("LOCAL_RANK", 0))), args,
                     init_method="env://")
    address = f"tcp://localhost:{_free_port()}"
    if world == 1:
        return _run_rank(0, fn, 1, address, device, args)
    torch.multiprocessing.start_processes(_run_rank, args=(fn, world, address, device, args),
                                          nprocs=world, join=True, start_method="spawn")
    return None


def world() -> tuple:
    """(rank, world size) of this process: (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard(batch, rank: int, world_size: int):
    """This rank's contiguous slice of each array of a global batch."""
    if world_size == 1:
        return batch
    per = batch[0].shape[0] // world_size
    return tuple(x[rank * per:(rank + 1) * per] for x in batch)
