"""The tracker's SDF term around the decoder in two kernels: wrappers and
plain versions.

A GN evaluation of the SDF term is three launches on the card:

  * ``sdf_rows``: the GN prefix's points through the delta pose (the GN
    state's, read by pointer) and the last pose, the voxel lookup, the
    count gate and the point mask -> the decoder's (N, 32) input [latent,
    rel], the points in the last camera's frame ``p_delta`` (N, 3) and
    ``use`` (N,) = mask & valid;
  * ``mlp.decoder_forward_grad`` on that input (unchanged);
  * ``sdf_hg``: the residuals sdf / std, the Jacobian chained to the twist
    of the last pose, the robust weight and the reduction -> (44,) =
    [H (6, 6), g (6), energy, count], H, g and the energy scaled by
    1 / max(count, 1).

The kernels live in ``csrc/sdf_term.cu``.  ``sdf_rows_plain`` and
``sdf_hg_plain`` are the PyTorch composition they replace (the point
transforms, ``voxel.decoder_rows`` as ``system/map.py`` ``get_sdf`` runs it,
and the tracker's old ``_sdf_Hg`` arithmetic, op for op), the CPU path and
the kernels' reference.  A wrapper launches its kernel for CUDA tensors
(or raises) and takes its plain version only for CPU tensors; it counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from . import voxel as vox
from .mlp import DECODER_IN
from .photometric import MAX_BLOCKS, ROBUST_KERNELS, robust_weight

_OUT = 44               # H (36), g (6), energy, count


def _f32_reciprocal(x: float) -> float:
    """1 / x as PyTorch's CUDA kernels take it when they divide a tensor by
    the Python scalar x: both rounded to float32 first."""
    return float(np.float32(1.0) / np.float32(x))


def sdf_rows_plain(pts, mask, dR, dt, last_R, last_t, bound_min, voxel_size: float, n_xyz,
                   indexer, obs_count, latents, count_th: float):
    """``sdf_rows`` in PyTorch ops: (x (N, 32), p_delta (N, 3), use (N,) bool)."""
    p_delta = pts @ dR.T + dt[None, :]                        # delta @ p
    xyz = p_delta @ last_R.T + last_t[None, :]
    x, valid = vox.decoder_rows(xyz, bound_min, voxel_size, n_xyz, indexer, obs_count,
                                latents, count_th)
    return x, p_delta, mask & valid


def sdf_hg_plain(out, grad, p_delta, use, last_R, voxel_size: float, robust_kernel,
                 robust_k: float):
    """``sdf_hg`` in PyTorch ops: (44,) = [H (6, 6), g (6), energy, count]."""
    sdf, std = out[:, 0], out[:, 1]
    r = sdf / std
    # d r / d p_world: 1 / std (std held constant), the kernel's d sdf / d rel
    # and d rel / d p_world = 1 / voxel_size, in the order autograd chains them
    dsdf_dpos = (torch.ones_like(std) / std)[:, None] * grad / voxel_size
    m = use.to(r.dtype)
    # The twist lives in the last-camera frame (delta <- exp(xi) o delta),
    # so the world gradient chain-rules through d x_world / d rho = R_last.
    La = last_R.T @ dsdf_dpos.T                               # (3, M)
    q = p_delta.T                                             # (3, M)
    Lb = torch.stack([q[1] * La[2] - q[2] * La[1],
                      q[2] * La[0] - q[0] * La[2],
                      q[0] * La[1] - q[1] * La[0]], 0)
    J = torch.cat([La, Lb], dim=0)                            # (6, M)
    w = robust_weight(r, robust_kernel, robust_k) * m
    count = m.sum()
    scale = 1.0 / torch.clamp_min(count, 1.0)
    H = ((J * w[None, :]) @ J.T) * scale
    g = (J @ (w * r)) * scale
    energy = torch.sum(r * (w * r)) * scale
    return torch.cat([H.reshape(-1), g, energy.reshape(1), count.reshape(1)])


_WORKSPACE: dict = {}


def _workspace(device):
    """Per device: ``sdf_hg``'s block partials and ticket (zero between
    launches; the kernel's last block resets it), its own beside
    ``photometric_hg``'s.  Allocated at the first call, which on the
    tracker's path is the eager warm-up before any graph capture."""
    ws = _WORKSPACE.get(device)
    if ws is None:
        ws = (torch.empty(MAX_BLOCKS * 32, dtype=torch.float32, device=device),
              torch.zeros(1, dtype=torch.int32, device=device))
        _WORKSPACE[device] = ws
    return ws


def _check(what, operands):
    """Each of ``operands`` ((name, tensor, dtype, shape), ...) of its dtype
    and shape, and contiguous on the card (the kernel reads it by pointer;
    the plain version takes any layout)."""
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or (
                t.device.type == "cuda" and not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a {dtype} {tuple(shape)} tensor, "
                             f"contiguous on the card, got {tuple(t.shape)} {t.dtype}")


def sdf_rows(pts, mask, dR, dt, last_R, last_t, bound_min, voxel_size: float, n_xyz,
             indexer, obs_count, latents, count_th: float):
    """The decoder's input of the SDF term at the delta pose (dR, dt), which
    the kernel reads on the device: (x (N, 32), p_delta (N, 3), use (N,)
    bool)."""
    what = "sdf_rows"
    n = pts.shape[0]
    cap, lat = latents.shape
    n_xyz = tuple(int(v) for v in n_xyz)
    _check(what, (("pts", pts, torch.float32, (n, 3)), ("mask", mask, torch.bool, (n,)),
                  ("dR", dR, torch.float32, (3, 3)), ("dt", dt, torch.float32, (3,)),
                  ("last_R", last_R, torch.float32, (3, 3)),
                  ("last_t", last_t, torch.float32, (3,)),
                  ("bound_min", bound_min, torch.float32, (3,)),
                  ("indexer", indexer, torch.int32, (int(np.prod(n_xyz)),)),
                  ("obs_count", obs_count, torch.float32, (cap,)),
                  ("latents", latents, torch.float32, (cap, DECODER_IN - 3))))
    if cuda_build.on_cpu(what, pts, mask, dR, dt, last_R, last_t, bound_min, indexer,
                         obs_count, latents):
        return sdf_rows_plain(pts, mask, dR, dt, last_R, last_t, bound_min, voxel_size,
                              n_xyz, indexer, obs_count, latents, count_th)
    dev = pts.device
    x = torch.empty((n, DECODER_IN), dtype=torch.float32, device=dev)
    p_delta = torch.empty((n, 3), dtype=torch.float32, device=dev)
    use = torch.empty(n, dtype=torch.bool, device=dev)
    lib = cuda_build.load("sdf_term")
    cuda_build.check(lib.sdf_rows(
        pts.data_ptr(), mask.data_ptr(), dR.data_ptr(), dt.data_ptr(), last_R.data_ptr(),
        last_t.data_ptr(), bound_min.data_ptr(), _f32_reciprocal(voxel_size), *n_xyz,
        indexer.data_ptr(), obs_count.data_ptr(), latents.data_ptr(), cap, lat,
        float(count_th), n, x.data_ptr(), p_delta.data_ptr(), use.data_ptr(),
        cuda_build.stream_ptr(dev)), what)
    cuda_build.count_launch(sdf_rows)
    return x, p_delta, use


def sdf_hg(out, grad, p_delta, use, last_R, voxel_size: float, robust_kernel,
           robust_k: float):
    """The SDF term's normal equations from the decoder's rows: (44,) =
    [H (6, 6), g (6), energy, count]."""
    what = "sdf_hg"
    if robust_kernel not in ROBUST_KERNELS:
        raise NotImplementedError(robust_kernel)
    n = out.shape[0]
    _check(what, (("out", out, torch.float32, (n, 2)), ("grad", grad, torch.float32, (n, 3)),
                  ("p_delta", p_delta, torch.float32, (n, 3)),
                  ("use", use, torch.bool, (n,)),
                  ("last_R", last_R, torch.float32, (3, 3))))
    if cuda_build.on_cpu(what, out, grad, p_delta, use, last_R):
        return sdf_hg_plain(out, grad, p_delta, use, last_R, voxel_size, robust_kernel,
                            robust_k)
    dev = out.device
    partials, ticket = _workspace(dev)
    result = torch.empty(_OUT, dtype=torch.float32, device=dev)
    lib = cuda_build.load("sdf_term")
    cuda_build.check(lib.sdf_hg(
        out.data_ptr(), grad.data_ptr(), p_delta.data_ptr(), use.data_ptr(),
        last_R.data_ptr(), _f32_reciprocal(voxel_size), ROBUST_KERNELS[robust_kernel],
        float(robust_k), _f32_reciprocal(robust_k), n, partials.data_ptr(), MAX_BLOCKS,
        ticket.data_ptr(), result.data_ptr(), cuda_build.stream_ptr(dev)), what)
    cuda_build.count_launch(sdf_hg)
    return result


sdf_rows.launches = 0
sdf_hg.launches = 0
