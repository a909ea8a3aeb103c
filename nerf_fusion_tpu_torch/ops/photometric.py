"""The tracker's photometric term in one kernel: wrapper and plain version.

``photometric_hg`` returns the normal equations of the photometric term at
one pyramid level, (H (6, 6), g (6,), energy (), count ()), for a relative
pose (R, t) with the level's ``K`` = (K, K^-1) (the warp's K R K^-1 and
K t formed inside the kernel, R and t read by pointer), or given as
``R`` = K R K^-1 and ``t`` = K t where ``K`` is None:

  * ``Dense(intensity, depth, gradient)``: the current level's planes,
    evaluated at every ``stride``-th pixel (``imgproc.rgb_odometry``);
  * ``Sparse(W, H, pix)``: a selected pixel set, ``pix`` from
    ``imgproc.select_photometric_pixels`` (``imgproc.rgb_odometry_sparse``).

The residual f and the warp Jacobian J (negated: the warp's is
d / d(-xi)) are weighted by the robust kernel on the valid pixels and
scaled by ``rgb_weight / max(count, 1)``: H = (J w) J^T, g = J (w f),
energy = sum f w f.

The kernel (``csrc/photometric.cu``) does the warp, the row gather from the
previous frame's packed rows, the residual, the Jacobian, the weights and
the reduction in one launch; it replaces the row gather of the JAX
package's probe (``tools/gather_exp3.py`` ``pallas_gather``) where the
tracker runs it.  ``photometric_hg_plain`` is the plain PyTorch
composition it replaces.  The wrapper launches the kernel for CUDA tensors
(or raises) and takes the plain version only for CPU tensors; it counts
its launches in ``photometric_hg.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_build, imgproc

ROBUST_KERNELS = {None: 0, "huber": 1, "tukey": 2}
MAX_BLOCKS = 1024       # block partials the workspace holds (the grid is <= the SMs)
_OUT = 44               # H (36), g (6), energy, count


class Dense(NamedTuple):
    intensity: torch.Tensor     # (H, W)
    depth: torch.Tensor         # (H, W)
    gradient: torch.Tensor      # (2, H, W)


class Sparse(NamedTuple):
    W: int
    H: int
    pix: tuple                  # select_photometric_pixels(...)


def robust_weight(x, kernel: str, k: float):
    if kernel is None:
        return torch.ones_like(x)
    ax = torch.abs(x)
    if kernel == "huber":
        return torch.where(ax > k, k / torch.clamp_min(ax, 1e-12), torch.ones_like(x))
    if kernel == "tukey":
        w = (1.0 - (x / k) ** 2) ** 2
        return torch.where(ax <= k, w, torch.zeros_like(x))
    raise NotImplementedError(kernel)


def photometric_hg_plain(prev_rows, level, R, t, fx, fy, cx, cy, *, K=None,
                         min_grad_scale: float, max_depth_delta: float, stride: int,
                         robust_kernel, robust_k: float, rgb_weight):
    """The photometric term in plain PyTorch: (H, g, energy, count)."""
    if K is None:
        krkinv, kt = R, t
    else:
        Km, Kinv = K
        krkinv, kt = Km @ R @ Kinv, Km @ t
    if isinstance(level, Sparse):
        f, J, ok = imgproc.rgb_odometry_sparse(prev_rows, level.W, level.H, level.pix,
                                               fx, fy, cx, cy, krkinv, kt,
                                               max_depth_delta)
    else:
        f, J, ok = imgproc.rgb_odometry(prev_rows, level.intensity, level.depth,
                                        level.gradient, fx, fy, cx, cy, krkinv, kt,
                                        min_grad_scale, max_depth_delta, stride=stride)
    J = -J  # the warp Jacobian is d/d(-xi)
    m = ok.to(f.dtype)
    w = robust_weight(f, robust_kernel, robust_k) * m
    count = m.sum()
    # rgb_weight / max(count, 1) as PyTorch evaluates a Python scalar over a
    # tensor: reciprocal, then product (for a float or a () tensor alike)
    scale = torch.reciprocal(torch.clamp_min(count, 1.0)) * rgb_weight
    J2, f2, w2 = J.reshape(6, -1), f.reshape(-1), w.reshape(-1)
    H = ((J2 * w2[None]) @ J2.T) * scale
    g = (J2 @ (w2 * f2)) * scale
    energy = torch.sum(f2 * (w2 * f2)) * scale
    return H, g, energy, count


_WORKSPACE: dict = {}


def _workspace(device):
    """Per device: the block partials and the ticket (zero between launches;
    the kernel's last block resets it).  Allocated at the first call, which
    on the tracker's path is the eager warm-up before any graph capture."""
    ws = _WORKSPACE.get(device)
    if ws is None:
        ws = (torch.empty(MAX_BLOCKS * 32, dtype=torch.float32, device=device),
              torch.zeros(1, dtype=torch.int32, device=device))
        _WORKSPACE[device] = ws
    return ws


@functools.lru_cache(maxsize=None)
def _identity(device) -> torch.Tensor:
    """I (3, 3) on ``device``, made once: the K and K^-1 of a call given
    K R K^-1 and K t themselves."""
    return torch.eye(3, dtype=torch.float32, device=device)


def _check_f32(what, name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous float32 {tuple(shape)} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def photometric_hg(prev_rows, level, R, t, fx, fy, cx, cy, *, K=None,
                   min_grad_scale: float, max_depth_delta: float, stride: int,
                   robust_kernel, robust_k: float, rgb_weight):
    """The photometric term at one level: (H (6, 6), g (6,), energy (), count ()).

    ``R`` (3, 3), ``t`` (3,): the relative pose, with ``K`` the level's
    (K (3, 3), K^-1 (3, 3)); where ``K`` is None, K R K^-1 and K t.
    ``rgb_weight``: a float or a () float32 tensor on the operands' device.
    The kernel reads R, t, K and the weight through pointers, so a captured
    graph sees the pose and the weight that the tracker's state holds."""
    what = "photometric_hg"
    if robust_kernel not in ROBUST_KERNELS:
        raise NotImplementedError(robust_kernel)
    if isinstance(level, Sparse):
        W, H = int(level.W), int(level.H)
        vecs, valid = tuple(level.pix[:6]), level.pix[6]
        n = vecs[0].shape[0]
        for name, v in zip(("u", "v", "i1", "d1", "gx", "gy"), vecs):
            _check_f32(what, name, v, (n,))
        if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or not valid.is_contiguous():
            raise ValueError(f"{what}: valid must be a contiguous bool ({n},) tensor")
        vecs += (valid,)
    elif isinstance(level, Dense):
        H, W = level.intensity.shape
        vecs = tuple(level)
        for name, v, shape in zip(("intensity", "depth", "gradient"), vecs,
                                  ((H, W), (H, W), (2, H, W))):
            _check_f32(what, name, v, shape)
        if int(stride) < 1:
            raise ValueError(f"{what}: stride must be >= 1, got {stride}")
    else:
        raise ValueError(f"{what}: level must be Dense or Sparse, got {type(level)}")
    _check_f32(what, "prev_rows", prev_rows, (H * W, 2))
    _check_f32(what, "R", R, (3, 3))
    _check_f32(what, "t", t, (3,))
    Ks = () if K is None else tuple(K)
    for name, k in zip(("K", "K^-1"), Ks):
        _check_f32(what, name, k, (3, 3))
    if H * W >= 2 ** 31:
        raise ValueError(f"{what}: more than 2^31 - 1 source rows")
    if cuda_build.on_cpu(what, prev_rows, R, t, *Ks, *vecs):
        return photometric_hg_plain(
            prev_rows, level, R, t, fx, fy, cx, cy, K=K, min_grad_scale=min_grad_scale,
            max_depth_delta=max_depth_delta, stride=stride, robust_kernel=robust_kernel,
            robust_k=robust_k, rgb_weight=rgb_weight)
    if prev_rows.data_ptr() % 8:
        raise ValueError(f"{what}: prev_rows is not 8-byte aligned")
    dev = prev_rows.device
    partials, ticket = _workspace(dev)
    out = torch.empty(_OUT, dtype=torch.float32, device=dev)
    if not torch.is_tensor(rgb_weight):
        rgb_weight = torch.full((), float(rgb_weight), dtype=torch.float32, device=dev)
    _check_f32(what, "rgb_weight", rgb_weight, ())
    if rgb_weight.device != dev:
        raise ValueError(f"{what}: rgb_weight on {rgb_weight.device}, operands on {dev}")
    Km, Kinv = Ks or (_identity(dev),) * 2
    pose = (R.data_ptr(), t.data_ptr(), Km.data_ptr(), Kinv.data_ptr())
    lib = cuda_build.load("photometric")
    scalars = (float(fx), float(fy), float(cx), float(cy))
    tail = (ROBUST_KERNELS[robust_kernel], float(robust_k), rgb_weight.data_ptr(),
            partials.data_ptr(), MAX_BLOCKS, ticket.data_ptr(), out.data_ptr(),
            cuda_build.stream_ptr(dev))
    if isinstance(level, Sparse):
        status = lib.photometric_hg_sparse(
            prev_rows.data_ptr(), W, H, *(v.data_ptr() for v in vecs), n, *pose, *scalars,
            float(max_depth_delta), *tail)
    else:
        status = lib.photometric_hg_dense(
            prev_rows.data_ptr(), W, H, *(v.data_ptr() for v in vecs), int(stride), *pose,
            *scalars, float(min_grad_scale), float(max_depth_delta), *tail)
    cuda_build.check(status, what)
    cuda_build.count_launch(photometric_hg)
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


photometric_hg.launches = 0
