"""Latent-code refinement: Adam on the latents of confident voxels.

Counterpart of the JAX package's ``system/refine.py``.  For the voxels
that are refine-eligible (allocated, ``obs_count >= encoder_count_th``,
not yet optimized), the surface points are gathered with the x8 corner
trick, jittered along their normals by ``sdf ~ N(0, 0.05^2)``, and the
jitter becomes the SDF target of a clamped Gaussian NLL with an L2 code
term; ``n_iters`` Adam steps run on the masked (C, L) latent buffer.  The
decoder runs under autograd through ``Decoder.differentiable`` (forward
the ``decoder_forward`` kernel, backward the ``decoder_vjp`` kernel) and
the latent gradient comes back through the gather (``index_select``, whose
backward is an ``index_add_``: atomics on the card, so two runs agree
bitwise only under ``torch.use_deterministic_algorithms``); nothing inside
the loop reads a tensor on the host.

The jitter is an input of ``refine_latents_core`` (``refine_latents``
draws it from a ``torch.Generator``): JAX's ``jax.random`` draw cannot be
reproduced, so the tests feed JAX's draw to the core.  Adam is written
out as JAX writes it (the gradient masked by eligibility, bias correction
with ``i + 1``).  The code term's gradient at an all-zero latent (a
never-observed dummy voxel) is 0 here, NaN in JAX (the norm's derivative
at 0); both mask it, and only eligible rows are merged.

``AsyncRefiner`` runs one job at a time on the fusion loop's worker
(``system/worker.py``: one thread and one CUDA stream, shared with the
async mesher), on a snapshot of the map taken at dispatch:
the port's map is written in place (the tracker's CUDA graphs read its
storage), so the worker never reads the live tensors.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops import voxel as vox
from .map import _CORNER_OFFSETS, MapConfig, MapState
from .worker import Worker

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class RefineResult(NamedTuple):
    latents: torch.Tensor       # (C, L) optimised latent buffer
    refined: torch.Tensor       # (C,) bool: the slots that were optimised
    old_latents: torch.Tensor   # (C, L) snapshot at dispatch
    old_counts: torch.Tensor    # (C,)


class RefineTargets(NamedTuple):
    """The samples of one refinement: corner pairs of the surface points."""
    eligible: torch.Tensor      # (C,) bool
    slot: torch.Tensor          # (8N,) int64, clamped to [0, C)
    pos: torch.Tensor           # (8N, 3) jittered voxel-local positions
    gt: torch.Tensor            # (8N,) target sdf, clipped to +-0.2
    weight: torch.Tensor        # (8N,) f32: 1 where the pair counts
    n_samples: torch.Tensor     # () f32, at least 1


def draw_jitter(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """(N, 8) normal draws x 0.05: the jitter of each (point, corner) pair."""
    return torch.randn((n, 8), generator=generator, device=device) * 0.05


def refine_targets(state: MapState, cfg: MapConfig, points, normals, valid,
                   gt_sdf) -> RefineTargets:
    """Eligibility and the x8 corner samples, restricted to eligible voxels.
    ``points`` / ``normals`` in the world frame; ``gt_sdf`` (N, 8)."""
    C = cfg.latent_capacity
    dev = points.device
    bound_min = torch.as_tensor(cfg.bound_min, dtype=torch.float32, device=dev)
    xyz_norm = (points - bound_min[None, :]) / cfg.voxel_size
    eligible = (state.positions >= 0) & (state.obs_count >= cfg.encoder_count_th) \
        & ~state.optimized
    offs = torch.as_tensor(_CORNER_OFFSETS, device=dev)
    tgt = vox.clamp_grid(torch.ceil(xyz_norm[:, None, :] + offs[None]).long() - 1, cfg.n_xyz)
    rel = xyz_norm[:, None, :] - tgt.to(torch.float32) - 0.5
    tgt_slot = state.indexer.long()[vox.linearize_id(tgt, cfg.n_xyz)]
    slot_c = tgt_slot.clamp(0, C - 1)
    contrib = valid[:, None] & (tgt_slot >= 0) & eligible[slot_c]
    pos = rel + gt_sdf[..., None] * normals[:, None, :]
    weight = contrib.reshape(-1).to(torch.float32)
    return RefineTargets(eligible, slot_c.reshape(-1), pos.reshape(-1, 3),
                         gt_sdf.reshape(-1).clamp(-0.2, 0.2), weight,
                         torch.clamp_min(weight.sum(), 1.0))


def refine_loss(latents: torch.Tensor, decoder, t: RefineTargets,
                code_reg_lambda: float):
    """(loss, mean NLL): the clamped Gaussian NLL over the weighted samples
    plus the L2 code term of the eligible latents, both over the sample
    count."""
    # index_select, whose backward is one index_add_ (atomics on the card):
    # the backward of latents[t.slot] (a sorted index_put_) adds each slot's
    # duplicates serially, and the pairs without a sample all read slot 0
    out = decoder.differentiable(torch.cat([torch.index_select(latents, 0, t.slot), t.pos],
                                           dim=1))
    mu = out[:, 0].clamp(-0.2, 0.2)
    sig = out[:, 1]
    nll = 0.5 * ((t.gt - mu) / sig) ** 2 + torch.log(sig)
    ll = torch.sum(nll * t.weight) / t.n_samples
    reg = code_reg_lambda * torch.sum(
        torch.linalg.vector_norm(latents, dim=1) * t.eligible) / t.n_samples
    return ll + reg, ll


def refine_latents_core(state: MapState, cfg: MapConfig, decoder, points, normals, valid,
                        gt_sdf, n_iters: int = 10, lr: float = 1e-2,
                        code_reg_lambda: float = 1e-2, log: dict = None) -> RefineResult:
    """``n_iters`` Adam steps on the latents of the eligible voxels against
    the targets of ``gt_sdf`` (N, 8).  ``log`` (optional) gets device
    tensors: ``eligible`` and ``sampled`` voxel counts, ``nll`` (n_iters,)
    the mean NLL at each step."""
    t = refine_targets(state, cfg, points, normals, valid, gt_sdf)
    mask = t.eligible[:, None].to(torch.float32)
    lat = state.latents.clone()
    m = torch.zeros_like(lat)
    v = torch.zeros_like(lat)
    nlls = []
    for i in range(n_iters):
        x = lat.detach().requires_grad_()
        with torch.enable_grad():
            loss, ll = refine_loss(x, decoder, t, code_reg_lambda)
            (g,) = torch.autograd.grad(loss, x)
        nlls.append(ll.detach())
        g = g * mask
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        mh = m / (1.0 - ADAM_B1 ** (i + 1.0))
        vh = v / (1.0 - ADAM_B2 ** (i + 1.0))
        lat = lat - lr * mh / (torch.sqrt(vh) + ADAM_EPS)
    if log is not None:
        sampled = torch.zeros(cfg.latent_capacity + 1, dtype=torch.bool, device=lat.device)
        sampled[torch.where(t.weight > 0, t.slot, cfg.latent_capacity)] = True
        log.update(eligible=t.eligible.sum(), sampled=sampled[:-1].sum(),
                   nll=torch.stack(nlls) if nlls else torch.zeros(0, device=lat.device))
    return RefineResult(lat, t.eligible, state.latents, state.obs_count)


def refine_latents(state: MapState, cfg: MapConfig, decoder, points, normals, valid,
                   generator: torch.Generator, **kwargs) -> RefineResult:
    """``refine_latents_core`` with the jitter drawn from ``generator``."""
    gt = draw_jitter(points.shape[0], generator, points.device)
    return refine_latents_core(state, cfg, decoder, points, normals, valid, gt, **kwargs)


def merge_refined(state: MapState, res: RefineResult, deintegrate: bool) -> MapState:
    """Fold a refinement back into the (possibly newer) state.  With
    ``deintegrate``, what was fused during the refinement stays:
    ``new = cur + (opt - old) * old_count / cur_count``."""
    mask = res.refined
    if deintegrate:
        cur = torch.clamp_min(state.obs_count, 1.0)[:, None]
        orig = res.old_counts[:, None]
        merged = state.latents + (res.latents - res.old_latents) * orig / cur
    else:
        merged = res.latents
    latents = torch.where(mask[:, None], merged, state.latents)
    return state._replace(latents=latents, optimized=state.optimized | mask)


class StageClock:
    """Time of one piece of device work: CUDA events on the card (read
    later, without a sync now), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.t0 = self.t1 = None

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t1.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1)
        return 1e3 * (self.t1 - self.t0)


class AsyncRefiner:
    """Single-outstanding-job refinement on the fusion loop's ``Worker``.

    ``dispatch`` copies the map state and the frame's samples on the
    caller's stream and submits ``refine_latents_core`` to the worker (its
    thread and, on the card, its stream; see ``system/worker.py``).
    ``collect`` returns the result once the job is done (its tensors then
    wait for the caller's stream before their memory is reused), None
    before."""

    def __init__(self, worker: Worker):
        self.worker = worker
        self.future = None

    def busy(self) -> bool:
        return self.future is not None and not self.future.done()

    def dispatch(self, state: MapState, cfg: MapConfig, decoder, points, normals, valid,
                 gt_sdf, log: dict = None, **kwargs):
        if self.future is not None:
            raise RuntimeError("AsyncRefiner: the last job is running or not collected")
        state = MapState(*(t.clone() for t in state))
        points, normals, valid, gt_sdf = (t.clone() for t in (points, normals, valid, gt_sdf))
        clock = StageClock(self.worker.device)
        if log is not None:
            log["clock"] = clock

        def job():
            clock.start()
            res = refine_latents_core(state, cfg, decoder, points, normals, valid, gt_sdf,
                                      log=log, **kwargs)
            clock.stop()
            return res

        self.future = self.worker.submit(job)

    def collect(self):
        """The finished ``RefineResult``, or None while the job runs."""
        if self.future is None or not self.future.done():
            return None
        res = self.future.result()
        self.future = None
        if self.worker.stream is not None:
            cur = torch.cuda.current_stream(self.worker.device)
            for t in res:
                t.record_stream(cur)
        return res

    def join(self):
        """Wait for the running job, if any (its result stays to collect)."""
        if self.future is not None:
            self.future.exception()
