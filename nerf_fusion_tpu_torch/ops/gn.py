"""One Gauss-Newton step with the group's state on the device: wrapper and
plain version.

The step is the body of the JAX tracker's per-group ``while_loop``
(``nerf_fusion_tpu/system/tracker.py:288-310``): it takes the normal
equations (H (6, 6), g (6,)) and the energy of the current delta pose,
rejects a worse or non-finite energy by reverting to the best pose,
otherwise solves for the twist and composes ``exp(xi)`` onto the delta.
The state (``GNState``) lives in four device tensors that the step updates
in place, so a GN evaluation and its step can be replayed as one CUDA
graph; the host keeps the loop's condition ``!done & i <= n_iters`` and
reads only the one-byte ``done`` flag.  A step that ends its group (worse,
or the last step) resets ``i``, ``used`` and the best energy for the next
group and leaves the group's best pose as the delta.

The step takes the normal equations as they are, or the group's terms
apart: sequences of each term's H, g and energy, which it sums as the
tracker's ``build_Hg`` does (``sum_terms``), inside the kernel on the card,
so that no PyTorch kernel runs between the terms' kernels and the step.  It
returns the sums.

``gn_step`` launches the kernel of ``csrc/gn.cu`` for CUDA tensors (or
raises) and takes ``gn_step_plain``, the same step in PyTorch ops, only for
CPU tensors; it counts its launches in ``gn_step.launches``.  The kernel has
no Pallas source: the JAX package leaves the loop body to XLA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from ..utils import se3_torch as st

STATE = 25      # dR (9), dt (3), bR (9), bt (3), best energy
MAX_TERMS = 8   # terms of one group the kernel sums (csrc/gn.cu kMaxTerms)


class GNState(NamedTuple):
    pose: torch.Tensor      # (25,) f32: dR, dt, bR, bt, best energy
    ints: torch.Tensor      # (2,) int32: i, used
    done: torch.Tensor      # (1,) bool: the last step's energy was worse
    iters: torch.Tensor     # (G,) int32: iters_used of each group

    @property
    def dR(self):
        return self.pose[0:9].view(3, 3)

    @property
    def dt(self):
        return self.pose[9:12]


def _initial_pose(device) -> torch.Tensor:
    eye = torch.eye(3, dtype=torch.float32).reshape(-1)
    zero = torch.zeros(3, dtype=torch.float32)
    inf = torch.tensor([float("inf")], dtype=torch.float32)
    return torch.cat([eye, zero, eye, zero, inf]).to(device)


def new_state(n_groups: int, device) -> GNState:
    """The state of a frame's first group: identity delta, no energy yet."""
    return GNState(_initial_pose(device), torch.zeros(2, dtype=torch.int32, device=device),
                   torch.zeros(1, dtype=torch.bool, device=device),
                   torch.zeros(n_groups, dtype=torch.int32, device=device))


def reset(state: GNState, initial: torch.Tensor):
    """Back to the first group's state in place (device ops only, so it may
    be captured); ``initial`` is ``new_state(...).pose`` kept aside."""
    state.pose.copy_(initial)
    state.ints.zero_()
    state.done.zero_()
    state.iters.zero_()


def sum_terms(H, g, energy):
    """The normal equations of a group from its terms' sequences of H, g and
    energy: zeros, then each term added in order."""
    dev = H[0].device
    Hs = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    gs = torch.zeros(6, dtype=torch.float32, device=dev)
    es = torch.zeros((), dtype=torch.float32, device=dev)
    for Ht, gt, et in zip(H, g, energy):
        Hs, gs, es = Hs + Ht, gs + gt, es + et
    return Hs, gs, es


def gn_step_plain(H, g, energy, state: GNState, group: int, n_iters: int):
    """The step in PyTorch ops, in place: the arithmetic of the host loop it
    replaced (``solve_ex``, the non-finite guard, ``se3_exp``, ``compose``).
    H, g, energy: tensors, or the terms' sequences (``sum_terms``).
    :return: (H, g, energy) summed."""
    if not torch.is_tensor(H):
        H, g, energy = sum_terms(H, g, energy)
    pose, ints = state.pose, state.ints
    dR, dt = pose[0:9].view(3, 3), pose[9:12]
    bR, bt, best = pose[12:21].view(3, 3), pose[21:24], pose[24]
    i, used = ints[0], ints[1]
    worse = (energy > best) | ~torch.isfinite(energy)
    bR2 = torch.where(worse, bR, dR)
    bt2 = torch.where(worse, bt, dt)
    best2 = torch.where(worse, best, energy)
    eye6 = 1e-9 * torch.eye(6, dtype=torch.float32, device=H.device)
    xi, _ = torch.linalg.solve_ex(H + eye6, -g)
    # a singular H gives a non-finite step: keep the pose
    xi = torch.where(torch.isfinite(xi).all(), xi, torch.zeros_like(xi))
    eR, et = st.se3_exp(xi)
    nR, nt = st.compose(eR, et, dR, dt)
    update = ~worse & (i < n_iters)
    used2 = torch.where(worse, used, i)
    finished = worse | (i + 1 > n_iters)
    new = torch.cat([torch.where(update, nR, bR2).reshape(-1), torch.where(update, nt, bt2),
                     bR2.reshape(-1), bt2,
                     torch.where(finished, torch.full_like(best2, float("inf")),
                                 best2).reshape(1)])
    zero = torch.zeros_like(i)
    new_ints = torch.stack([torch.where(finished, zero, i + 1),
                            torch.where(finished, zero, used2)])
    pose.copy_(new)
    ints.copy_(new_ints)
    state.iters[group] = used2
    state.done.copy_(worse.reshape(1))
    return H, g, energy


def _check(what, name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def gn_step(H, g, energy, state: GNState, group: int, n_iters: int):
    """One GN step of group ``group`` (of ``n_iters`` steps), in place.
    H (6, 6), g (6,), energy (): tensors, or sequences of 1 to
    ``MAX_TERMS`` of them, the group's terms in order, which the step sums
    (``sum_terms``).  :return: (H, g, energy) summed."""
    what = "gn_step"
    summed = torch.is_tensor(H)
    if summed:
        H, g, energy = (H,), (g,), (energy,)
    H, g, energy = tuple(H), tuple(g), tuple(energy)
    if not 1 <= len(H) <= MAX_TERMS or len(g) != len(H) or len(energy) != len(H):
        raise ValueError(f"{what}: 1 to {MAX_TERMS} terms of H, g and energy each, got "
                         f"{len(H)}, {len(g)}, {len(energy)}")
    n_groups = state.iters.shape[0]
    for name, t, dtype, shape in ((("pose", state.pose, torch.float32, (STATE,)),
                                   ("ints", state.ints, torch.int32, (2,)),
                                   ("done", state.done, torch.bool, (1,)),
                                   ("iters", state.iters, torch.int32, (n_groups,)))
                                  + tuple(("H", t, torch.float32, (6, 6)) for t in H)
                                  + tuple(("g", t, torch.float32, (6,)) for t in g)
                                  + tuple(("energy", t, torch.float32, ()) for t in energy)):
        _check(what, name, t, dtype, shape)
    if not 0 <= int(group) < n_groups or int(n_iters) < 0:
        raise ValueError(f"{what}: group {group} of {n_groups}, n_iters {n_iters}")
    if cuda_build.on_cpu(what, *H, *g, *energy, *state):
        if summed:
            return gn_step_plain(H[0], g[0], energy[0], state, int(group), int(n_iters))
        return gn_step_plain(H, g, energy, state, int(group), int(n_iters))
    dev = state.pose.device
    out = torch.empty(43, dtype=torch.float32, device=dev)
    parts = [t.data_ptr() for term in zip(H, g, energy) for t in term]
    lib = cuda_build.load("gn")
    cuda_build.check(lib.gn_step((ctypes.c_void_p * len(parts))(*parts), len(H),
                                 out.data_ptr(), state.pose.data_ptr(), state.ints.data_ptr(),
                                 state.done.data_ptr(), state.iters.data_ptr(), int(group),
                                 int(n_iters), cuda_build.stream_ptr(dev)), what)
    cuda_build.count_launch(gn_step)
    return out[:36].view(6, 6), out[36:42], out[42]


gn_step.launches = 0
