"""The decoder and encoder MLP kernels: CUDA wrappers and plain versions.

Counterpart of the JAX package's ``ops/pallas_mlp.py``.  The kernels live
in ``csrc/mlp.cu``; this module folds the weights, packs them in the
kernels' layout (``pack_decoder``, ``pack_encoder``: the tensor cores'
fragment order), and exposes four wrappers:

  * ``decoder_forward``       (N, 32) -> (N, 2) [sdf, std]
  * ``decoder_forward_grad``  (N, 32) -> (N, 2), (N, 3) d sdf / d x[:, 29:32]
  * ``decoder_vjp``           (N, 32), (N, 2) g -> (N, 32) g^T d[sdf, std] / dx
  * ``encoder_forward``       (N, 6)  -> (N, 29)

and ``DecoderFn``, the decoder as a ``torch.autograd.Function``: forward
``decoder_forward``, backward ``decoder_vjp``.  A wrapper launches its
kernel for a CUDA tensor (or raises) and takes the plain PyTorch version
beside it only for a CPU tensor.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

DECODER_IN = 32
DECODER_LATENT = 29
DECODER_PACKED = 49890
ENCODER_IN = 6
ENCODER_OUT = 29
ENCODER_PACKED = 27264


def fold_decoder_weights(params: dict) -> list:
    """Weight-norm (g, v, b) -> [(W (in, out), b)] for lin0, lin1, ... and unc.

    ``params`` holds numpy arrays in the JAX pytree layout
    ({'lin0': {'v', 'g', 'b'} | {'w', 'b'}, ..., 'unc': {'w', 'b'}}).
    Folded in float64 and rounded once to f32, so the result does not
    depend on a reduction's summation order.
    """
    mats = []
    for name in [f"lin{i}" for i in range(len(params) - 1)] + ["unc"]:
        p = {k: torch.tensor(np.asarray(v), dtype=torch.float64)
             for k, v in params[name].items()}
        if "v" in p:
            v = p["v"]
            w = p["g"][:, None] * v / torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
        else:
            w = p["w"]
        mats.append((w.T.float().contiguous(), p["b"].float().contiguous()))
    return mats


def fold_encoder_weights(params: dict, bn_state: dict, n_layers: int,
                         has_bn, eps: float = 1e-5) -> list:
    """Eval BatchNorm folded into [(W (in, out), b)] per layer (in float64,
    rounded once to f32)."""
    mats = []
    for i in range(n_layers):
        p = {k: torch.tensor(np.asarray(v), dtype=torch.float64)
             for k, v in params[f"layer{i}"].items()}
        w = p["w"].T
        b = p.get("b", torch.zeros(w.shape[1], dtype=torch.float64))
        if has_bn(i):
            s = {k: torch.tensor(np.asarray(v), dtype=torch.float64)
                 for k, v in bn_state[f"layer{i}"].items()}
            scale = s["scale"] * torch.rsqrt(s["var"] + eps)
            w = w * scale[None, :]
            b = (b - s["mean"]) * scale + s["bias"]
        mats.append((w.float().contiguous(), b.float().contiguous()))
    return mats


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> the tensor cores' B-fragment order of the MLP kernels:
    element (kb, nb, g, t, j) = W[8kb + 2t + j, 8nb + g], so lane 4g + t of
    a warp loads its two values of K block kb, N block nb as one float2, and
    K positions t, t + 4 of the fragment hold rows 2t, 2t + 1 of the block:
    the columns that an m16n8 accumulator lane holds."""
    k, n = w.shape
    return w.reshape(k // 8, 4, 2, n // 8, 8).permute(0, 3, 4, 1, 2).reshape(-1)


def pack_decoder(mats) -> torch.Tensor:
    """Folded decoder [(W, b)] -> the decoder kernel's flat f32 buffer: the
    four hidden layers' matrices in B-fragment order (``_fragments``), each
    followed by its bias, then lin4 and unc as they are."""
    parts = []
    for i, (w, b) in enumerate(mats):
        parts += [_fragments(w) if i < 4 else w.reshape(-1), b.reshape(-1)]
    return torch.cat(parts).contiguous()


ENCODER_CHUNK = 64      # columns of the 256-wide layer per chunk in the kernel


def pack_encoder(mats) -> torch.Tensor:
    """Folded encoder [(W, b)] (6-32-64-256-29) -> the encoder kernel's flat
    f32 buffer: each layer's matrix in B-fragment order (``_fragments``)
    followed by its bias.  The first matrix is padded to 8 rows and the
    last to 32 columns (bias too) with zeros; the 256-wide layer is stored
    as its four (64, 64) column chunks one after the other, the order in
    which the kernel streams it."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = mats
    w0p = torch.zeros((8, w0.shape[1]), dtype=torch.float32)
    w0p[:w0.shape[0]] = w0
    w3p = torch.zeros((w3.shape[0], 32), dtype=torch.float32)
    w3p[:, :w3.shape[1]] = w3
    b3p = torch.zeros(32, dtype=torch.float32)
    b3p[:b3.shape[0]] = b3
    chunks = [_fragments(w2[:, c:c + ENCODER_CHUNK])
              for c in range(0, w2.shape[1], ENCODER_CHUNK)]
    return torch.cat([_fragments(w0p), b0, _fragments(w1), b1, *chunks, b2,
                      _fragments(w3p), b3p]).contiguous()


def _softplus(z):
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))


# ---------------------------------------------------------------------------
# Plain versions (the CPU path; the reference the kernels are held to).
# ---------------------------------------------------------------------------

def decoder_forward_plain(x: torch.Tensor, mats) -> torch.Tensor:
    (w0, b0), (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wu, bu) = mats
    h = torch.relu(x @ w0 + b0)
    h = torch.relu(h @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    h = torch.cat([h, x], dim=1)                       # latent_in at lin3
    h = torch.relu(h @ w3 + b3)
    std = 0.05 + 0.5 * _softplus(h @ wu + bu)
    sdf = torch.tanh(h @ w4 + b4)
    return torch.cat([sdf, std], dim=1)


def decoder_forward_grad_plain(x: torch.Tensor, mats):
    """Forward plus d sdf / d x[:, 29:32] in forward mode (the kernel's
    algorithm): three tangents ride beside the activation, masked by each
    ReLU; the re-fed input brings its one-hot tangent in at lin3."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wu, bu) = mats
    n = x.shape[0]
    a = x @ w0 + b0
    t = w0[DECODER_LATENT:][:, None, :].expand(3, n, w0.shape[1])   # (3, N, 128)
    m = a > 0
    h, t = torch.relu(a), t * m
    for w, b in ((w1, b1), (w2, b2)):
        a = h @ w + b
        m = a > 0
        h, t = torch.relu(a), (t @ w) * m
    eye = torch.zeros(3, n, DECODER_IN, dtype=x.dtype, device=x.device)
    eye[torch.arange(3), :, DECODER_LATENT + torch.arange(3)] = 1.0
    h = torch.cat([h, x], dim=1)
    t = torch.cat([t, eye], dim=2)
    a = h @ w3 + b3
    m = a > 0
    h, t = torch.relu(a), (t @ w3) * m
    std = 0.05 + 0.5 * _softplus(h @ wu + bu)
    sdf = torch.tanh(h @ w4 + b4)
    grad = (1.0 - sdf * sdf) * (t @ w4)[..., 0].T
    return torch.cat([sdf, std], dim=1), grad


def decoder_vjp_plain(x: torch.Tensor, g: torch.Tensor, mats) -> torch.Tensor:
    """g (N, 2) [d sdf, d std] -> dx (N, 32), the kernel's algorithm: the
    forward pass keeping each ReLU's mask, the heads' coefficients
    (1 - sdf^2) and 0.5 sigmoid(unc), then the transposed products, lin3's
    split into the h branch and the re-fed input."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3), (w4, b4), (wu, bu) = mats
    a = x @ w0 + b0
    m0, h = a > 0, torch.relu(a)
    a = h @ w1 + b1
    m1, h = a > 0, torch.relu(a)
    a = h @ w2 + b2
    m2, h = a > 0, torch.relu(a)
    a = torch.cat([h, x], dim=1) @ w3 + b3
    m3, h = a > 0, torch.relu(a)
    sdf = torch.tanh(h @ w4 + b4)
    c4 = g[:, 0:1] * (1.0 - sdf * sdf)
    cu = g[:, 1:2] * (0.5 * torch.sigmoid(h @ wu + bu))
    d = torch.where(m3, c4 * w4[:, 0] + cu * wu[:, 0], 0.0) @ w3.T
    d_refed, d = d[:, w2.shape[1]:], d[:, :w2.shape[1]]
    d = torch.where(m2, d, 0.0) @ w2.T
    d = torch.where(m1, d, 0.0) @ w1.T
    return torch.where(m0, d, 0.0) @ w0.T + d_refed


def encoder_forward_plain(x: torch.Tensor, mats) -> torch.Tensor:
    h = x
    for i, (w, b) in enumerate(mats):
        h = h @ w + b
        if i < len(mats) - 1:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, width: int, packed: torch.Tensor, size: int, what: str,
           f64_on_cpu: bool = False):
    """``f64_on_cpu``: a float64 input on the CPU is taken too (the plain
    version computes in the input's type, with ``mats`` of that type)."""
    f64 = f64_on_cpu and x.device.type == "cpu" and x.dtype == torch.float64
    if (x.dtype != torch.float32 and not f64) or x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{what}: expected (N, {width}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if (packed.device != x.device or packed.dtype != torch.float32
            or packed.numel() != size or not packed.is_contiguous()):
        raise ValueError(f"{what}: packed weights must be a contiguous "
                         f"float32 ({size},) tensor on {x.device}")


def decoder_forward(x: torch.Tensor, packed: torch.Tensor, mats) -> torch.Tensor:
    """Eval decoder (N, 32) -> (N, 2) [sdf, std]."""
    _check(x, DECODER_IN, packed, DECODER_PACKED, "decoder_forward", f64_on_cpu=True)
    if cuda_build.on_cpu("decoder_forward", x):
        return decoder_forward_plain(x, mats)
    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("mlp")
    cuda_build.check(lib.decoder_forward(
        x.data_ptr(), packed.data_ptr(), x.shape[0], out.data_ptr(),
        cuda_build.stream_ptr(x.device)), "decoder_forward")
    cuda_build.count_launch(decoder_forward)
    return out


def decoder_forward_grad(x: torch.Tensor, packed: torch.Tensor, mats):
    """Eval decoder plus d sdf / d x[:, 29:32]: ((N, 2), (N, 3))."""
    _check(x, DECODER_IN, packed, DECODER_PACKED, "decoder_forward_grad")
    if cuda_build.on_cpu("decoder_forward_grad", x):
        return decoder_forward_grad_plain(x, mats)
    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    grad = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("mlp")
    cuda_build.check(lib.decoder_forward_grad(
        x.data_ptr(), packed.data_ptr(), x.shape[0], out.data_ptr(),
        grad.data_ptr(), cuda_build.stream_ptr(x.device)), "decoder_forward_grad")
    cuda_build.count_launch(decoder_forward_grad)
    return out, grad


def encoder_forward(x: torch.Tensor, packed: torch.Tensor, mats) -> torch.Tensor:
    """Eval cnp encoder (N, 6) -> (N, 29)."""
    _check(x, ENCODER_IN, packed, ENCODER_PACKED, "encoder_forward")
    if cuda_build.on_cpu("encoder_forward", x):
        return encoder_forward_plain(x, mats)
    out = torch.empty((x.shape[0], ENCODER_OUT), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("mlp")
    cuda_build.check(lib.encoder_forward(
        x.data_ptr(), packed.data_ptr(), x.shape[0], out.data_ptr(),
        cuda_build.stream_ptr(x.device)), "encoder_forward")
    cuda_build.count_launch(encoder_forward)
    return out


def decoder_vjp(x: torch.Tensor, g: torch.Tensor, packed: torch.Tensor,
                mats) -> torch.Tensor:
    """The eval decoder's vector-Jacobian product in its input: x (N, 32)
    and g (N, 2), the upstream gradient of [sdf, std] -> dx (N, 32).  The
    kernel reads the forward kernels' ``packed`` weights, the transposed
    products' fragments by a transposed index map."""
    _check(x, DECODER_IN, packed, DECODER_PACKED, "decoder_vjp", f64_on_cpu=True)
    if g.dtype != x.dtype or tuple(g.shape) != (x.shape[0], 2) or not g.is_contiguous():
        raise ValueError(f"decoder_vjp: g must be a contiguous ({x.shape[0]}, 2) {x.dtype} "
                         f"tensor, got {tuple(g.shape)} {g.dtype}")
    if cuda_build.on_cpu("decoder_vjp", x, g, packed):
        return decoder_vjp_plain(x, g, mats)
    dx = torch.empty_like(x)
    lib = cuda_build.load("mlp")
    cuda_build.check(lib.decoder_vjp(
        x.data_ptr(), g.data_ptr(), packed.data_ptr(), x.shape[0], dx.data_ptr(),
        cuda_build.stream_ptr(x.device)), "decoder_vjp")
    cuda_build.count_launch(decoder_vjp)
    return dx


class DecoderFn(torch.autograd.Function):
    """The eval decoder as a differentiable function of its input:
    ``DecoderFn.apply(x, packed, mats)`` -> (N, 2) [sdf, std]; forward
    ``decoder_forward``, backward ``decoder_vjp`` on the saved input, both
    on the same packed weights (constants)."""

    @staticmethod
    def forward(ctx, x, packed, mats):
        ctx.save_for_backward(x)
        ctx.packed, ctx.mats = packed, mats
        return decoder_forward(x, packed, mats)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return decoder_vjp(x, g.contiguous(), ctx.packed, ctx.mats), None, None


decoder_forward.launches = 0
decoder_forward_grad.launches = 0
decoder_vjp.launches = 0
encoder_forward.launches = 0
