"""The MLP kernels' 3xTF32 arithmetic, emulated in plain PyTorch.

The CUDA decoder (``csrc/mlp.cu``) runs its hidden layers as TF32
tensor-core products with the 3xTF32 split, reading the weights in the
fragment order that ``ops.mlp.pack_decoder`` writes; the encoder runs all
four layers so, from ``ops.mlp.pack_encoder``'s buffer (the first layer
padded to K = 8, the last to N = 32, the 256-wide layer streamed in four
64-column chunks into the last layer's accumulator).  The emulation below
repeats that arithmetic on the CPU: TF32 rounding as the kernel does it
(round to nearest, ties away from zero: add 0x1000 to the bit pattern and
clear the low 13 bits), the weights' staged split, the activations' split,
the three passes per K block in the kernel's order, the packed buffer read
by the kernel's fragment indexing, and the gradient variant's four planes
(tangent rows: one-hot input, no bias, the activation row's ReLU mask).
Seeded inputs shaped like the mesher's and the tracker's go through it,
through the JAX package's ``apply_decoder`` and interpret-mode
``decoder_forward_pallas``, and through a float64 plain version, all on the
``ckpt/default`` weights; the encoder's likewise through ``apply_encoder``,
interpret-mode ``encoder_forward_pallas`` and ``encoder_forward_plain``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.encoder import apply_encoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.ops.pallas_mlp import decoder_forward_pallas, encoder_forward_pallas
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
# The encoder kernel's padded layers and its 256-wide layer's column chunk.
ENCODER = [(8, 32), (32, 64), (64, 256), (256, 32)]
CHUNK = mlp.ENCODER_CHUNK


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
    """acc = bias + a W as the kernel sums it (``accumulate``)."""
    acc = torch.where(bias_rows[:, None], bias[None, :], torch.zeros(()))
    return accumulate(acc, a, frag, passes)


def accumulate(acc, a, frag, passes=3):
    """acc += a W as the kernel sums it: per K block, the three products
    a_lo w_hi, a_hi w_lo, a_hi w_hi, with W read by fragment indexing
    (kb, nb, g, t, j) -> W[8kb + 2t + j, 8nb + g]."""
    n = frag.shape[1] * 8
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


# ---------------------------------------------------------------------------
# The encoder kernel.
# ---------------------------------------------------------------------------

def encoder_fragments(packed):
    """[(frag (K/8, N/8, 8, 4, 2), bias)] of the four padded layers; the
    256-wide layer's frag is (4 chunks, 8, 8, 8, 4, 2)."""
    layers, o = [], 0
    for i, (k, n) in enumerate(ENCODER):
        if i == 2:
            frag = packed[o:o + k * n].reshape(n // CHUNK, k // 8, CHUNK // 8, 8, 4, 2)
        else:
            frag = packed[o:o + k * n].reshape(k // 8, n // 8, 8, 4, 2)
        layers.append((frag, packed[o + k * n:o + k * n + n]))
        o += k * n + n
    assert o == packed.numel() == mlp.ENCODER_PACKED
    return layers


def _unfragment(frag):
    kbs, nbs = frag.shape[:2]
    return frag.permute(0, 3, 4, 1, 2).reshape(8 * kbs, 8 * nbs)


def emulate_encoder(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The encoder kernel's arithmetic: (N, 6) -> (N, 29)."""
    (f0, b0), (f1, b1), (f2, b2), (f3, b3) = encoder_fragments(packed)
    n = x.shape[0]
    rows = torch.ones(n, dtype=torch.bool)
    xp = torch.cat([x, torch.zeros(n, 2)], 1)           # K = 6 padded to 8
    h = torch.relu(layer(xp, f0, b0, rows))
    h = torch.relu(layer(h, f1, b1, rows))
    acc = b3[None, :].expand(n, 32).clone()
    for c in range(f2.shape[0]):                          # 64-column chunks
        a = torch.relu(layer(h, f2[c], b2[CHUNK * c:CHUNK * (c + 1)], rows))
        kb = slice(c * CHUNK // 8, (c + 1) * CHUNK // 8)
        acc = accumulate(acc, a, f3[kb])                  # the last layer's K chunk
    return acc[:, :mlp.ENCODER_OUT]


def _encoder_inputs(kind: str, n: int = 2100) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "gaussian":
        return rng.standard_normal((n, 6)).astype(np.float32)
    # integrate_keyframe's features: corner offsets in [-1.5, 0.5], unit normals
    rel = rng.uniform(-1.5, 0.5, (n, 3))
    nrm = rng.standard_normal((n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([rel, nrm], 1).astype(np.float32)


def test_encoder_unpacking_gives_the_folded_matrices(models):
    """``pack_encoder``'s buffer unpacks exactly to ``fold_encoder_weights``
    (and the module's matrices), with zeros in the padding: rows 6-7 of the
    first matrix, columns 29-31 and bias 29-31 of the last."""
    jm, tm = models
    np_ = jax.tree_util.tree_map(np.asarray, (jm.encoder_params, jm.encoder_bn))
    folded = mlp.fold_encoder_weights(np_[0], np_[1], 4, lambda i: f"layer{i}" in np_[1])
    layers = encoder_fragments(tm.encoder.packed)
    (f0, b0), (f1, b1), (f2, b2), (f3, b3) = layers
    w2 = torch.cat([_unfragment(f2[c]) for c in range(f2.shape[0])], 1)
    unpacked = [(_unfragment(f0), b0), (_unfragment(f1), b1), (w2, b2),
                (_unfragment(f3), b3)]
    for (w, b), (fw, fb), (mw, mb) in zip(unpacked, folded, tm.encoder.mats, strict=True):
        k, n = fw.shape
        assert torch.equal(w[:k, :n], fw) and torch.equal(b[:n], fb)
        assert torch.equal(w[:k, :n], mw) and torch.equal(b[:n], mb)
        assert not w[k:].any() and not w[:, n:].any() and not b[n:].any()
    # element (kb, nb, lane = 4g + t, j) of the first chunk is W2[8kb + 2t + j, 8nb + g]
    flat = f2[1].reshape(8, CHUNK // 8, 32, 2)
    for kb, nb, lane, j in [(0, 0, 0, 0), (3, 5, 13, 1), (7, 7, 31, 1)]:
        g, t = lane // 4, lane % 4
        assert flat[kb, nb, lane, j] == folded[2][0][8 * kb + 2 * t + j,
                                                     CHUNK + 8 * nb + g]


@pytest.mark.parametrize("kind", ["features", "gaussian"])
def test_emulated_encoder_matches_float64_and_plain(models, kind):
    """Within 1e-4 of float64 and of the f32 plain version (the card's
    tolerance); a ragged row count (2100 = 131 tiles of 16 + 4)."""
    _, tm = models
    x = torch.as_tensor(_encoder_inputs(kind))
    out = emulate_encoder(x, tm.encoder.packed)
    m64 = [(w.double(), b.double()) for w, b in tm.encoder.mats]
    ref64 = mlp.encoder_forward_plain(x.double(), m64)
    assert out.shape == (2100, 29)
    assert (out.double() - ref64).abs().max() <= TOL_OUT
    assert (out - mlp.encoder_forward_plain(x, tm.encoder.mats)).abs().max() <= TOL_OUT


@pytest.mark.parametrize("kind", ["features", "gaussian"])
def test_emulated_encoder_matches_jax(models, kind):
    """Against ``apply_encoder`` (f32, relative to the latents' magnitude as
    in test_torch_models.py) and interpret-mode ``encoder_forward_pallas``
    (bf16x3: the Pallas tolerances)."""
    jm, tm = models
    x = _encoder_inputs(kind)
    out = emulate_encoder(torch.as_tensor(x), tm.encoder.packed).numpy()
    lat_j, _ = apply_encoder(jm.encoder_params, jm.encoder_bn, jm.encoder_config,
                             jnp.asarray(x), train=False)
    lat_j = np.asarray(lat_j)
    assert np.abs(out - lat_j).max() <= TOL_OUT * max(1.0, float(np.abs(lat_j).max()))
    lat_p = encoder_forward_pallas(jm.encoder_params, jm.encoder_bn, jm.encoder_config,
                                   jnp.asarray(x), interpret=True)
    err = np.abs(out - np.asarray(lat_p))
    assert err.max() < PALLAS_MAX and np.median(err) < PALLAS_MED
