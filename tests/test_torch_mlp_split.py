"""The decoder kernel's 3xTF32 arithmetic, emulated in plain PyTorch.

The CUDA decoder (``csrc/mlp.cu``) runs its hidden layers as TF32
tensor-core products with the 3xTF32 split, reading the weights in the
fragment order that ``ops.mlp.pack_decoder`` writes.  The emulation below
repeats that arithmetic on the CPU: TF32 rounding as the kernel does it
(round to nearest, ties away from zero: add 0x1000 to the bit pattern and
clear the low 13 bits), the weights' staged split, the activations' split,
the three passes per K block in the kernel's order, the packed buffer read
by the kernel's fragment indexing, and the gradient variant's four planes
(tangent rows: one-hot input, no bias, the activation row's ReLU mask).
Seeded inputs shaped like the mesher's and the tracker's go through it,
through the JAX package's ``apply_decoder`` and interpret-mode
``decoder_forward_pallas``, and through a float64 plain version, all on the
``ckpt/default`` weights.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops.pallas_mlp import decoder_forward_pallas
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import mlp
from nerf_fusion_tpu_torch.system.mesher import _sample_offsets

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
TOL_OUT = 1e-4     # sdf and std: the port's output tolerance (f32 exact)
TOL_GRAD = 1e-3    # d sdf / d xyz
# The interpret-mode Pallas kernel (bf16x3): the tolerances of test_pallas_mlp.py.
PALLAS_MAX, PALLAS_MED = 4e-3, 1e-4
MASK = -0x2000     # 0xffffe000: sign, exponent and 10 mantissa bits
HIDDEN = [(32, 128), (128, 128), (128, 96), (128, 128)]


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & MASK).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & MASK).view(torch.float32)


def split_activation(a):
    hi = rna(a)
    return hi, rna(a - hi)


def split_weight(w):
    """Staged as trunc(w) + rna(w - trunc(w)), split back by truncation."""
    staged = trunc(w) + rna(w - trunc(w))
    hi = trunc(staged)
    return hi, staged - hi


def unpacked_fragments(packed):
    """[(frag (K/8, N/8, 8, 4, 2), bias)] of the hidden layers, then the heads."""
    layers, o = [], 0
    for k, n in HIDDEN:
        layers.append((packed[o:o + k * n].reshape(k // 8, n // 8, 8, 4, 2),
                       packed[o + k * n:o + k * n + n]))
        o += k * n + n
    w4, b4 = packed[o:o + 128], packed[o + 128]
    wu, bu = packed[o + 129:o + 257], packed[o + 257]
    return layers, (w4, b4, wu, bu)


def layer(a, frag, bias, bias_rows, passes=3):
    """acc = bias + a W as the kernel sums it: per K block, the three products
    a_lo w_hi, a_hi w_lo, a_hi w_hi, with W read by fragment indexing
    (kb, nb, g, t, j) -> W[8kb + 2t + j, 8nb + g]."""
    n = frag.shape[1] * 8
    acc = torch.where(bias_rows[:, None], bias[None, :], torch.zeros(()))
    for kb in range(frag.shape[0]):
        wk = frag[kb].permute(2, 3, 0, 1).reshape(8, n)
        ah, al = split_activation(a[:, 8 * kb:8 * kb + 8])
        wh, wl = split_weight(wk)
        if passes == 3:
            acc = acc + al @ wh
            acc = acc + ah @ wl
        acc = acc + ah @ wh
    return acc


def emulate(x: torch.Tensor, packed: torch.Tensor, grad: bool, passes: int = 3):
    """The kernel's arithmetic: (N, 2) [sdf, std] and, with ``grad``, (N, 3)."""
    layers, (w4, b4, wu, bu) = unpacked_fragments(packed)
    n, planes = x.shape[0], 4 if grad else 1
    rows = x[None].repeat(planes, 1, 1)
    for s in range(1, planes):          # a tangent row: its xyz column one-hot
        rows[s] = 0.0
        rows[s, :, mlp.DECODER_LATENT - 1 + s] = 1.0
    rows = rows.reshape(planes * n, mlp.DECODER_IN)
    bias_rows = torch.arange(planes * n) < n

    def relu(acc):
        pre = acc.reshape(planes, n, -1)
        return torch.where(pre[:1] > 0, pre, torch.zeros(())).reshape(planes * n, -1)

    h = rows
    for i, (frag, bias) in enumerate(layers):
        if i == 3:
            h = torch.cat([h, rows], 1)     # latent_in at lin3
        h = relu(layer(h, frag, bias, bias_rows, passes))
    d4 = (h @ w4).reshape(planes, n)
    du = (h[:n] @ wu)
    sdf = torch.tanh(d4[0] + b4)
    std = 0.05 + 0.5 * (torch.clamp_min(du + bu, 0) + torch.log1p(torch.exp(-(du + bu).abs())))
    out = torch.stack([sdf, std], 1)
    if not grad:
        return out
    return out, ((1.0 - sdf * sdf) * d4[1:]).T


@pytest.fixture(scope="module")
def models():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    return jm, tm


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "mesher":   # 64 voxels x the 512 samples of the r = 4 margin lattice
        lat = (0.3 * rng.standard_normal((64, 29))).astype(np.float32)
        offs = _sample_offsets(4)
        return np.concatenate([np.repeat(lat, offs.shape[0], 0),
                               np.tile(offs, (64, 1))], 1)
    lat = (0.3 * rng.standard_normal((8192, 29))).astype(np.float32)   # tracker
    xyz = rng.uniform(-0.5, 0.5, (8192, 3)).astype(np.float32)
    return np.concatenate([lat, xyz], 1)


def _float64(x, mats):
    m64 = [(w.double(), b.double()) for w, b in mats]
    return mlp.decoder_forward_grad_plain(torch.as_tensor(x).double(), m64)


def test_unpacking_gives_the_folded_matrices(models):
    jm, tm = models
    packed = tm.decoder.packed
    assert packed.numel() == mlp.DECODER_PACKED
    folded = mlp.fold_decoder_weights(jax.tree_util.tree_map(np.asarray, jm.decoder_params))
    layers, (w4, b4, wu, bu) = unpacked_fragments(packed)
    unpacked = [(frag.permute(0, 3, 4, 1, 2).reshape(k, n), bias)
                for (frag, bias), (k, n) in zip(layers, HIDDEN)]
    unpacked += [(w4[:, None], b4.reshape(1)), (wu[:, None], bu.reshape(1))]
    for (w, b), (fw, fb), (mw, mb) in zip(unpacked, folded, tm.decoder.mats, strict=True):
        assert torch.equal(w, fw) and torch.equal(b, fb)
        assert torch.equal(w, mw) and torch.equal(b, mb)


def test_packed_layout_is_the_fragment_order(models):
    """Element (kb, nb, lane = 4g + t, j) of a hidden layer is
    W[8kb + 2t + j, 8nb + g]: lane 4g + t loads its B fragment (K positions
    t and t + 4 = rows 2t and 2t + 1 of the block) as one float2."""
    _, tm = models
    layers, heads = unpacked_fragments(tm.decoder.packed)
    rng = np.random.default_rng(0)
    for (frag, bias), (w, b) in zip(layers, tm.decoder.mats[:4]):
        assert torch.equal(bias, b)
        kbs, nbs = frag.shape[:2]
        flat = frag.reshape(kbs, nbs, 32, 2)
        for kb, nb, lane, j in zip(rng.integers(0, kbs, 64), rng.integers(0, nbs, 64),
                                   rng.integers(0, 32, 64), rng.integers(0, 2, 64)):
            g, t = lane // 4, lane % 4
            assert flat[kb, nb, lane, j] == w[8 * kb + 2 * t + j, 8 * nb + g]
    w4, b4, wu, bu = heads
    assert torch.equal(w4, tm.decoder.mats[4][0][:, 0]) and b4 == tm.decoder.mats[4][1][0]
    assert torch.equal(wu, tm.decoder.mats[5][0][:, 0]) and bu == tm.decoder.mats[5][1][0]


def test_split_parts_are_tf32_and_sum_back(models):
    """Both splits give TF32 parts (low 13 bits clear) whose sum is within
    2^-22 (weights) and 2^-23 (activations) of the value; the staged weight
    is their exact sum; TF32 rounding takes ties away from zero."""
    _, tm = models
    w = torch.cat([m.reshape(-1) for m, _ in tm.decoder.mats[:4]])
    a = torch.as_tensor(np.random.default_rng(1).standard_normal(100000).astype(np.float32))
    for v, split, rel in ((w, split_weight, 2.0 ** -22), (a, split_activation, 2.0 ** -23)):
        hi, lo = split(v)
        for part in (hi, lo):
            assert torch.all(part.view(torch.int32) & 0x1FFF == 0)
        err = (v.double() - hi.double() - lo.double()).abs()
        # 2^-136: the TF32 spacing among subnormals (the checkpoint holds some)
        assert torch.all(err <= rel * v.double().abs() + 2.0 ** -136)
    staged = trunc(w) + rna(w - trunc(w))
    hi, lo = split_weight(w)
    assert torch.equal(hi + lo, staged)
    ties = torch.tensor([0x3F801000, -0x407FF000], dtype=torch.int32).view(torch.float32)
    assert rna(ties).view(torch.int32).tolist() == [0x3F802000, -0x407FE000]


@pytest.mark.parametrize("kind", ["mesher", "tracker"])
def test_emulated_kernel_matches_float64(models, kind):
    _, tm = models
    x = _inputs(kind)
    ref, gref = _float64(x, tm.decoder.mats)
    out, grad = emulate(torch.as_tensor(x), tm.decoder.packed, grad=True)
    assert (out.double() - ref).abs().max() <= TOL_OUT
    # A ReLU input within f32 rounding of 0 may take the other side than in
    # float64, and the gradient jumps there (the f32 plain version too, on
    # one tracker row): hold 99.9 % of the rows, as on the card.
    gdiff = (grad.double() - gref).abs().amax(1)
    assert (gdiff <= TOL_GRAD).double().mean() >= 0.999
    # the forward variant is the gradient variant's activation plane
    assert torch.equal(emulate(torch.as_tensor(x), tm.decoder.packed, grad=False), out)


@pytest.mark.parametrize("kind", ["mesher", "tracker"])
def test_emulated_kernel_matches_jax(models, kind):
    jm, tm = models
    x = _inputs(kind)
    out = emulate(torch.as_tensor(x), tm.decoder.packed, grad=False).numpy()
    sdf_j, std_j = apply_decoder(jm.decoder_params, jm.decoder_config, jnp.asarray(x))
    assert np.abs(out[:, :1] - np.asarray(sdf_j)).max() <= TOL_OUT
    assert np.abs(out[:, 1:] - np.asarray(std_j)).max() <= TOL_OUT
    part = slice(0, 4096)   # interpret mode is slow; one tile row of the mesher
    sdf_p, std_p = decoder_forward_pallas(jm.decoder_params, jm.decoder_config,
                                          jnp.asarray(x[part]), interpret=True)
    err = np.abs(out[part, :1] - np.asarray(sdf_p))
    assert err.max() < PALLAS_MAX and np.median(err) < PALLAS_MED
    assert np.abs(out[part, 1:] - np.asarray(std_p)).max() < PALLAS_MAX


def test_one_tf32_pass_misses_the_tolerance(models):
    """Control: the same emulation with one TF32 product per K block (hi.hi
    only) misses the output tolerance on the mesher's inputs, so the tests
    above tell the three-pass split from one pass."""
    _, tm = models
    x = _inputs("mesher")
    ref, _ = _float64(x, tm.decoder.mats)
    out = emulate(torch.as_tensor(x), tm.decoder.packed, grad=False, passes=1)
    assert (out.double() - ref).abs().max() > 10 * TOL_OUT
