"""Joint encoder-decoder training of the local-geometry prior.

Counterpart of the JAX package's ``trainer/train.py`` (the reference's
``trainer/main.py:40-219``):

  * one step (``TrainStep``): the encoder in training mode (BatchNorm batch
    statistics), the latents repeated per SDF sample, the decoder with
    dropout, the configured losses, backward per ``batch_split`` chunk
    (gradients accumulate; the encoder's graph is kept until the last
    chunk), the surface |SDF| validation probe (eval mode), and two Adam
    updates, one for the decoder and one for the encoder, whose learning
    rates are set per epoch from the schedules;
  * batches from the host sampler (``LifDataset.sample_batch`` on a
    prefetch thread, copied through pinned memory) or, with
    ``device_data: true``, drawn on the card (``DeviceLifDataset``);
  * loss scalars stay on the device and are read every 10 steps, or once
    per ``steps_per_call`` steps (their mean) when that is above 1: the
    steps in between run back to back with no host read;
  * ``logs/scalars.jsonl``, per-epoch snapshots in the JAX package's npz
    layout with the optimizer states beside them, ``hyper.json``, and
    ``resume_epoch``;
  * data parallelism (``dp``, in a process group that ``parallel.launch``
    made): each rank keeps its slice of the global batch, both networks
    are ``DistributedDataParallel`` modules, the encoder's BatchNorm takes
    the statistics of the whole batch, the logged losses are the ranks'
    mean, dropout is seeded per (seed, rank), and rank 0 alone writes.

Products are f32 (the entry point keeps TF32 off), as the JAX trainer's
``Precision.HIGH``.  The training products are PyTorch's: the JAX package
trains through XLA, outside its Pallas kernels.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..data.lif_dataset import LifCombinedDataset, LifDataset, batch_iterator, prepare
from ..models import criterion
from ..models.io import (TrainNetworks, build_model, load_checkpoint, save_checkpoint,
                         write_hyper_json)
from .. import parallel
from ..utils.config import dict_to_args
from ..utils.meters import AverageMeter
from . import lr_schedule


class TrainStep:
    """``step(sdf (B, S, 4), surface (B, M, 6), epoch)`` -> the step's loss
    terms as 0-d tensors on the device (no host read).  With ``ddp`` (inside
    a process group) the batch is this rank's slice, and the losses are
    the mean over the ranks."""

    def __init__(self, model: TrainNetworks, loss_args, samples_per_lif: int,
                 batch_split: int, gen: torch.Generator, ddp: bool = False):
        self.model = model
        self.loss_args = loss_args
        self.loss_fns = criterion.get_losses(loss_args.types)
        self.samples_per_lif = samples_per_lif
        self.batch_split = batch_split
        self.gen = gen
        self.ddp = ddp
        self.dec, self.enc = model.decoder, model.encoder
        if ddp:
            from torch.nn.parallel import DistributedDataParallel as DDP

            dev = next(model.decoder.parameters()).device
            ids = None if dev.type == "cpu" else [dev]
            # the BN state is the same on every rank (global statistics)
            self.dec = DDP(model.decoder, device_ids=ids, broadcast_buffers=False)
            self.enc = DDP(model.encoder, device_ids=ids, broadcast_buffers=False)
            model.encoder.sync_stats = True
        self.dec_opt = torch.optim.Adam(model.decoder.parameters(), lr=1e-3)
        self.enc_opt = torch.optim.Adam(model.encoder.parameters(), lr=1e-3)

    def set_lr(self, lr_dec: float, lr_enc: float):
        for opt, lr in ((self.dec_opt, lr_dec), (self.enc_opt, lr_enc)):
            for group in opt.param_groups:
                group["lr"] = lr

    def state_dict(self) -> dict:
        return {"decoder": self.dec_opt.state_dict(), "encoder": self.enc_opt.state_dict()}

    def load_state_dict(self, state: dict):
        self.dec_opt.load_state_dict(state["decoder"])
        self.enc_opt.load_state_dict(state["encoder"])

    def loss_and_grads(self, sdf: torch.Tensor, surface: torch.Tensor, epoch) -> dict:
        """The losses' backward into ``.grad`` (accumulated over the
        ``batch_split`` chunks) and the step's loss terms.  The decoder's
        backward per chunk stops at the latents; the encoder's runs once
        from their summed gradient (under DDP the decoder's gradients are
        averaged over the ranks at the last chunk, the encoder's then)."""
        dec, enc = self.model.decoder, self.model.encoder
        dec.train()
        enc.train()
        B, S = surface.shape[0], self.samples_per_lif
        # this rank's count: DDP's mean over the ranks gives the global mean
        info = {"num_sdf_samples": B * S, "epoch": epoch}
        lat = self.enc(surface)                              # (B, L)
        lat_in = lat.detach().requires_grad_()
        lat_rep = lat_in.repeat_interleave(S, dim=0)         # (B * S, L)
        flat = sdf.reshape(-1, 4)
        xyz, gt = flat[:, :3], flat[:, 3:]
        needs_coords = criterion.siren_loss in self.loss_fns
        chunk = (B * S) // self.batch_split
        logs = {}
        for ci in range(self.batch_split):
            last = ci == self.batch_split - 1
            sl = slice(ci * chunk, (ci + 1) * chunk)
            coords = xyz[sl].detach().requires_grad_() if needs_coords else xyz[sl]
            with (self.dec.no_sync() if self.ddp and not last else contextlib.nullcontext()):
                pd_sdf, pd_std = self.dec(torch.cat([lat_rep[sl], coords], dim=1), self.gen)
                total = 0.0
                for lf in self.loss_fns:
                    for k, v in lf(self.loss_args, info, pd_sdf=pd_sdf, pd_sdf_std=pd_std,
                                   gt_sdf=gt[sl], latent_vecs=lat_rep[sl],
                                   coords=coords).items():
                        total = total + v
                        logs[k] = logs[k] + v.detach() if k in logs else v.detach()
                # the latents' repeat serves every chunk: keep it until the last
                total.backward(retain_graph=not last)
        lat.backward(lat_in.grad)
        # validation probe: |SDF| at the (clean) surface points, eval mode
        with torch.no_grad():
            dec.eval()
            surf_lat = lat.detach().repeat_interleave(surface.shape[1], dim=0)
            v_sdf, _ = dec(torch.cat([surf_lat, surface[..., :3].reshape(-1, 3)], dim=1))
            dec.train()
        logs["validation"] = v_sdf.abs().mean()
        if self.ddp:
            # one collective for every term: the ranks' mean
            keys = sorted(logs)
            vals = torch.stack([logs[k] for k in keys])
            torch.distributed.all_reduce(vals)
            logs = dict(zip(keys, vals / torch.distributed.get_world_size()))
        return logs

    def __call__(self, sdf: torch.Tensor, surface: torch.Tensor, epoch) -> dict:
        logs = self.loss_and_grads(sdf, surface, epoch)
        self.dec_opt.step()
        self.enc_opt.step()
        self.dec_opt.zero_grad(set_to_none=True)
        self.enc_opt.zero_grad(set_to_none=True)
        return logs


class ScalarLogger:
    """``scalars.jsonl``: one ``{"tag", "step", ...values}`` record a line."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.f = (self.logdir / "scalars.jsonl").open("a")

    def update(self, tag, step, values: dict):
        self.f.write(json.dumps({"tag": tag, "step": step, **values}) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # pinned, so the copy is queued behind the step without a host sync
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host_batches(dataset, batch_size, seed, n_steps, device, rank=0, world=1):
    """The global batches of the epoch; each rank copies its slice."""
    for sdf, surf, _ in batch_iterator(dataset, batch_size, seed=seed, max_batches=n_steps):
        sdf, surf = parallel.shard((sdf, surf), rank, world)
        yield _to_device(sdf, device), _to_device(surf, device)


def _device_batches(dev_ds, batch_size, seed, n_steps, gen):
    perm = np.random.RandomState(seed).permutation(len(dev_ds))[:n_steps * batch_size]
    perm = _to_device(perm.reshape(n_steps, batch_size), dev_ds.device)
    for s in range(n_steps):
        yield dev_ds.sample(perm[s], gen)


def _read(logs: dict) -> dict:
    return {k: float(v) for k, v in logs.items()}


def run_dir(args) -> Path:
    """``<save_dir>/<run_name>``, where a run writes."""
    return Path(getattr(args, "save_dir", "../di-checkpoints")) / args.run_name


def train(args, max_steps_per_epoch: int = None, seed: int = 0, dataset=None,
          resume_epoch: int = None, device="cuda", step_hook=None, dp: bool = False):
    """Run the training loop. Returns (model, save_dir).

    :param dataset: a pre-built dataset; by default one is built from
        ``args.train_set``.
    :param resume_epoch: resume from this snapshot in the run directory
        (params, BN state, both optimizers' states and the epoch counter),
        on every rank.
    :param step_hook: called as ``step_hook(it)`` after each step is queued
        (``it`` counts steps from 1 over the run); it must not read the device.
    :param dp: data-parallel over the process group this process is in.
    """
    device = torch.device(device)
    rank, world = parallel.world() if dp else (0, 1)
    if args.batch_size % world:
        raise ValueError(f"batch_size {args.batch_size} is not a multiple of the "
                         f"data-parallel degree {world}")
    if max_steps_per_epoch is None:
        max_steps_per_epoch = getattr(args, "max_steps_per_epoch", None)
    checkpoints = sorted(list(range(args.snapshot_frequency, args.num_epochs + 1,
                                    args.snapshot_frequency))
                         + list(args.additional_snapshots))

    schedules = lr_schedule.get_learning_rate_schedules(args)
    model = build_model(args, seed=seed)
    if dataset is None:
        dataset = LifCombinedDataset(*[LifDataset(**t, num_sample=args.samples_per_lif)
                                       for t in args.train_set])
    logging.info("dataset: %d LIFs", len(dataset))

    save_dir = run_dir(args)
    writer = rank == 0
    if writer:
        save_dir.mkdir(parents=True, exist_ok=True)
        write_hyper_json(save_dir, args)
    if dp:
        # rank 0 writes the packed pools; the others read them after it
        if writer:
            prepare(dataset)
        torch.distributed.barrier()

    start_epoch = 1
    if resume_epoch is not None:
        load_checkpoint(model, save_dir, resume_epoch)
        start_epoch = resume_epoch + 1
    model.to(device)
    # dropout draws per (seed, rank)
    gen = torch.Generator(device=device).manual_seed((seed + (resume_epoch or 0)) * world + rank)
    step = TrainStep(model, dict_to_args(args.training_loss), args.samples_per_lif,
                     args.batch_split, gen, ddp=dp)
    if resume_epoch is not None:
        opt_path = save_dir / f"optimizer_{resume_epoch}.pt"
        if opt_path.exists():
            step.load_state_dict(torch.load(opt_path, map_location=device))
        logging.info("resumed from epoch %d", resume_epoch)

    dev_ds = None
    if bool(getattr(args, "device_data", False)) and dp:
        logging.warning("device_data ignored under data parallelism")
    elif bool(getattr(args, "device_data", False)):
        from ..data.device_lif import DeviceLifDataset

        dev_ds = DeviceLifDataset.from_dataset(dataset, device)
        logging.info("device-resident LIF pools: %.2f GB", dev_ds.nbytes / 1e9)
    steps_per_call = int(getattr(args, "steps_per_call", 1))

    viz = ScalarLogger(save_dir / "logs") if writer else None
    n_full = len(dataset) // args.batch_size
    it = (start_epoch - 1) * max(n_full, 1)
    t0 = time.time()
    try:
        for epoch in range(start_epoch, args.num_epochs + 1):
            lr_dec = schedules[0].get_learning_rate(epoch)
            lr_enc = schedules[1].get_learning_rate(epoch)
            step.set_lr(lr_dec, lr_enc)
            meter = AverageMeter()
            n_steps = n_full if max_steps_per_epoch is None else min(n_full, max_steps_per_epoch)
            if dev_ds is not None:
                batches = _device_batches(dev_ds, args.batch_size, seed + epoch, n_steps, gen)
            else:
                batches = _host_batches(dataset, args.batch_size, seed + epoch, n_steps, device,
                                        rank, world)

            def log(values):
                host = _read(values)
                meter.append_loss(host)
                for k, v in host.items():
                    if viz is not None:
                        viz.update(f"train/{k}", it, {"scalar": v})

            pending, last_logs = [], None
            for s, (sdf_b, surf_b) in enumerate(batches):
                last_logs = step(sdf_b, surf_b, epoch)
                it += 1
                if step_hook is not None:
                    step_hook(it)
                if steps_per_call > 1:
                    pending.append(last_logs)
                    if len(pending) == steps_per_call or s == n_steps - 1:
                        log({k: torch.stack([p[k] for p in pending]).mean()
                             for k in last_logs})
                        pending = []
                elif it % 10 == 0:
                    log(last_logs)
            if not meter.loss_dict and last_logs is not None:
                # short epochs (< 10 steps) would otherwise log nothing
                meter.append_loss(_read(last_logs))
            if not writer:
                continue
            for k, v in meter.get_mean_loss_dict().items():
                viz.update(f"epoch_sum/{k}", epoch, {"train": v})
            viz.update("train_stat/lr_0", epoch, {"scalar": lr_dec})
            logging.info("epoch %d (%.1fs): %s", epoch, time.time() - t0,
                         meter.get_printable_mean())
            if epoch in checkpoints:
                save_checkpoint(save_dir, epoch, model,
                                extra={"opt": {"epoch": np.asarray(epoch)}})
                torch.save(step.state_dict(), save_dir / f"optimizer_{epoch}.pt")
    finally:
        if viz is not None:
            viz.close()
    return model, save_dir
