"""The decoder VJP kernel's 3xTF32 arithmetic, emulated in plain PyTorch.

``decoder_vjp`` (``csrc/mlp.cu``) reads the forward kernels' buffer
(``ops.mlp.pack_decoder``), staged in shared memory with each matrix entry
split as trunc(w) + rna(w - trunc(w)) and swizzled within its 64-float
fragment blocks (float f of a block at f ^ ((f >> 2) & 8)).  It runs the
forward pass keeping each hidden layer's ReLU mask as bits (register (nb, i)
of a lane's accumulator tile is bit 4 (nb % 8) + i of word nb / 8), the
heads in f32 (each lane sums its 32 columns with fmas, two xor-shuffles sum
the row), lin3's output gradient mask3 (c4 w4 + cu wu), and the four
transposed products, each B fragment of W^T read from W's copy at
16 t + 8 (j ^ (t >> 1)) + g of block (n / 8, k / 8).  The emulation below
repeats that: the TF32 rounding (add 0x1000, clear the low 13 bits), the
staged split, the activations' split, the three passes per K block in the
kernel's order (a_lo w_hi, a_hi w_lo, a_hi w_hi; in the forward pass summed
apart and added to the layer's sum, as the kernel's K-block sums), both
index maps read from the staged, swizzled buffer, the mask words and the
heads' coefficients.  What it does not repeat is how the tensor cores add
inside one mma (eight products and the accumulator aligned and truncated).
Seeded rows shaped like the refinement's go through it, through JAX's
``jax.vjp`` of ``apply_decoder`` and through float64 ``decoder_vjp_plain``,
on the ``ckpt/default`` weights.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import mlp

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
HI = jax.lax.Precision.HIGHEST
TOL_ROW = 1e-3     # dx: of each row's largest |entry|, on 99.9 % of the rows (ReLU kinks)
MASK = -0x2000     # 0xffffe000: sign, exponent and 10 mantissa bits
HIDDEN = [(32, 128), (128, 128), (128, 96), (128, 128)]
N_ROWS = 4099      # 256 tiles of 16 rows and a partial one


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & MASK).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & MASK).view(torch.float32)


def matrix_ranges():
    """(start, K, N) of each hidden matrix in ``pack_decoder``'s buffer, and
    the offsets of lin4, its bias, unc and its bias."""
    out, o = [], 0
    for k, n in HIDDEN:
        out.append((o, k, n))
        o += k * n + n
    return out, (o, o + 128, o + 129, o + 257)


def swizzle(f: torch.Tensor) -> torch.Tensor:
    return f ^ ((f >> 2) & 8)


def stage(packed: torch.Tensor, split: bool = True) -> torch.Tensor:
    """The kernel's shared-memory image of ``packed``: each matrix entry
    staged (``split``) and moved to its swizzled place within its matrix."""
    sw = packed.clone()
    for start, k, n in matrix_ranges()[0]:
        w = packed[start:start + k * n]
        if split:
            w = trunc(w) + rna(w - trunc(w))
        sw[start + swizzle(torch.arange(k * n))] = w
    return sw


def forward_index(start: int, k: int, n: int) -> torch.Tensor:
    """(K, N) offsets in the staged image of the forward B fragments: lane
    4g + t reads slot s = lane ^ ((lane >> 2) & 4) of block (kb, nb), float
    2s + j, for element (8kb + 2t + j, 8nb + g)."""
    kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
    kb, t, j = kk // 8, (kk % 8) // 2, kk % 2
    nb, g = nn // 8, nn % 8
    lane = 4 * g + t
    slot = lane ^ ((lane >> 2) & 4)
    return start + (kb * (n // 8) + nb) * 64 + 2 * slot + j


def transposed_index(start: int, k: int, n: int) -> torch.Tensor:
    """(N, K) offsets of W^T's B fragments for the (K, N) matrix W at
    ``start``: element (8kb + 2t + j, 8nb + g) of W^T at float
    16t + 8(j ^ (t >> 1)) + g of block (nb, kb) (``accumulate_t``)."""
    kk, nn = torch.meshgrid(torch.arange(n), torch.arange(k), indexing="ij")
    kb, t, j = kk // 8, (kk % 8) // 2, kk % 2
    nb, g = nn // 8, nn % 8
    return start + (nb * (n // 8) + kb) * 64 + 16 * t + 8 * (j ^ (t >> 1)) + g


def staged_matrices(packed: torch.Tensor):
    """[(W, W^T)] of the hidden layers as the kernel reads them (staged
    values, split back by truncation in ``accumulate``)."""
    sw = stage(packed)
    return [(sw[forward_index(*r)], sw[transposed_index(*r)]) for r in matrix_ranges()[0]]


def accumulate(acc, a, w, block_sums=False):
    """acc += a W as the kernel sums it: per K block the three products
    a_lo w_hi, a_hi w_lo, a_hi w_hi (w staged: hi = trunc, lo = the rest),
    with ``block_sums`` into a fresh sum added to acc."""
    wh = trunc(w)
    wl = w - wh
    for kb in range(w.shape[0] // 8):
        blk = slice(8 * kb, 8 * kb + 8)
        ah = rna(a[:, blk])
        al = rna(a[:, blk] - ah)
        s = acc if not block_sums else torch.zeros_like(acc)
        s = s + al @ wh[blk]
        s = s + ah @ wl[blk]
        s = s + ah @ wh[blk]
        acc = acc + s if block_sums else s
    return acc


def mask_words(m: torch.Tensor) -> torch.Tensor:
    """A (16 T, 8 NB) bool mask -> (T, 32 lanes, words) int64 as the kernel
    keeps it: lane 4g + t's register (nb, i) is row g + 8 (i >> 1), column
    8nb + 2t + (i & 1) of its tile, bit 4 (nb % 8) + i of word nb // 8."""
    rows, cols = m.shape
    nbs = cols // 8
    tiles = m.reshape(rows // 16, 16, cols)
    lane, nb, i = torch.meshgrid(torch.arange(32), torch.arange(nbs), torch.arange(4),
                                 indexing="ij")
    r = lane // 4 + 8 * (i >> 1)
    c = 8 * nb + 2 * (lane % 4) + (i & 1)
    bits = tiles[:, r, c].long() << (4 * (nb % 8) + i)           # (T, 32, NB, 4)
    words = (nbs + 7) // 8
    bits = torch.cat([bits, bits.new_zeros(bits.shape[0], 32, 8 * words - nbs, 4)], 2)
    return bits.reshape(rows // 16, 32, words, 32).sum(-1)


def unmask(words: torch.Tensor, cols: int) -> torch.Tensor:
    """``mask_words``'s inverse: what ``gate`` reads back."""
    nbs = cols // 8
    tiles = words.shape[0]
    lane, nb, i = torch.meshgrid(torch.arange(32), torch.arange(nbs), torch.arange(4),
                                 indexing="ij")
    on = (words[:, lane, nb // 8] >> (4 * (nb % 8) + i)) & 1
    m = torch.zeros(tiles, 16, cols, dtype=torch.bool)
    m[:, lane // 4 + 8 * (i >> 1), 8 * nb + 2 * (lane % 4) + (i & 1)] = on.bool()
    return m.reshape(16 * tiles, cols)


def relu_masked(acc):
    """h and the mask as the kernel keeps it (the words and back)."""
    on = unmask(mask_words(acc > 0), acc.shape[1])
    return torch.where(on, acc, torch.zeros(())), on


def f32_fma(a, b, c):
    """fmaf: one rounding (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def heads(h, w4, wu, b4, bu, g):
    """(c4, cu) as the kernel computes them: each lane t sums columns
    8nb + 2t, 8nb + 2t + 1 with fmas, two xor-shuffles sum the lanes."""
    rows = h.shape[0]
    d4 = torch.zeros(rows, 4)
    du = torch.zeros(rows, 4)
    for nb in range(16):
        for jj in range(2):
            k = 8 * nb + 2 * torch.arange(4) + jj
            d4 = f32_fma(h[:, k], w4[k], d4)
            du = f32_fma(h[:, k], wu[k], du)
    d4 = (d4[:, 0] + d4[:, 1]) + (d4[:, 2] + d4[:, 3])
    du = (du[:, 0] + du[:, 1]) + (du[:, 2] + du[:, 3])
    sdf = torch.tanh(d4 + b4)
    sig = 1.0 / (1.0 + torch.exp(-(du + bu)))
    return g[:, 0] * (1.0 - sdf * sdf), g[:, 1] * (0.5 * sig)


def emulate_vjp(x: torch.Tensor, g: torch.Tensor, packed: torch.Tensor, passes: int = 3):
    """The kernel's arithmetic: x (N, 32), g (N, 2) -> dx (N, 32).  With
    ``passes=1`` each product is the one hi.hi TF32 pass (the control)."""
    (ranges, (o4, ob4, ou, obu)) = matrix_ranges()
    mats = staged_matrices(packed)
    if passes == 1:
        mats = [(trunc(w), trunc(wt)) for w, wt in mats]
    biases = [packed[s + k * n:s + k * n + n] for s, k, n in ranges]
    n = x.shape[0]
    pad = -n % 16                                   # a partial tile reads zeros
    x = torch.cat([x, torch.zeros(pad, x.shape[1])])
    g = torch.cat([g, torch.zeros(pad, 2)])
    prod = accumulate if passes == 3 else (lambda acc, a, w, block_sums=False:
                                           acc + rna(a) @ w)

    h, masks = x, []
    for i, ((w, _), b) in enumerate(zip(mats, biases)):
        if i == 3:
            h = torch.cat([h, x], 1)                # latent_in at lin3
        h, m = relu_masked(prod(b[None, :].expand(h.shape[0], -1), h, w, block_sums=True))
        masks.append(m)
    c4, cu = heads(h, packed[o4:o4 + 128], packed[ou:ou + 128], packed[ob4], packed[obu], g)
    d = torch.where(masks[3], f32_fma(c4[:, None], packed[o4:o4 + 128][None],
                                      cu[:, None] * packed[ou:ou + 128][None]), 0.0)
    zero = torch.zeros(d.shape[0], 128)
    d = prod(zero, d, mats[3][1])                   # lin3^T
    refed, d = d[:, 96:], torch.where(masks[2], d[:, :96], 0.0)
    d = torch.where(masks[1], prod(zero, d, mats[2][1]), 0.0)    # lin2^T
    d = torch.where(masks[0], prod(zero, d, mats[1][1]), 0.0)    # lin1^T
    return prod(refed, d, mats[0][1])[:n]           # lin0^T, from the re-fed part


@pytest.fixture(scope="module")
def models():
    jm, _ = jax_load_model(CKPT, 300)
    tm, _ = load_model(CKPT, 300)
    return jm, tm


def _refine_rows(n: int = N_ROWS, seed: int = 12):
    """Rows shaped like a refinement's: latents of the map's scale, the
    voxel-local positions of corner pairs jittered along their normals, and
    the NLL's upstream gradient (d mu, d sigma) over the sample count."""
    rng = np.random.RandomState(seed)
    lat = (0.3 * rng.randn(n, 29)).astype(np.float32)
    pos = rng.uniform(-0.5, 0.5, (n, 3)) + 0.05 * rng.randn(n, 1) * rng.randn(n, 3)
    x = np.concatenate([lat, pos], 1).astype(np.float32)
    g = (rng.randn(n, 2) * np.array([4.0, 20.0]) / n).astype(np.float32)
    return x, g


def _rows_within(dx, ref):
    """Share of rows within ``TOL_ROW`` of the row's largest |entry|."""
    scale = np.maximum(np.abs(ref).max(1), 1e-30)
    return float((np.abs(dx - ref).max(1) <= TOL_ROW * scale).mean())


def _float64(x, g, mats):
    m64 = [(w.double(), b.double()) for w, b in mats]
    return mlp.decoder_vjp_plain(torch.as_tensor(x).double(), torch.as_tensor(g).double(),
                                 m64).numpy()


def test_unpacking_gives_the_folded_matrices_and_transposes(models):
    """Both index maps, read from the swizzled buffer (unstaged), give back
    ``fold_decoder_weights``' matrices and their transposes exactly; each
    swizzle is a permutation within its matrix, and the buffer is the
    forward kernels' (``Decoder.packed``)."""
    jm, tm = models
    packed = tm.decoder.packed
    assert packed.numel() == mlp.DECODER_PACKED
    folded = mlp.fold_decoder_weights(jax.tree_util.tree_map(np.asarray, jm.decoder_params))
    sw = stage(packed, split=False)
    for (start, k, n), (w, _), (fw, _) in zip(matrix_ranges()[0], tm.decoder.mats, folded):
        f = torch.arange(k * n)
        assert torch.equal(torch.sort(swizzle(f)).values, f)
        assert torch.equal(sw[forward_index(start, k, n)], fw)
        assert torch.equal(sw[transposed_index(start, k, n)], fw.T)
        assert torch.equal(fw, w)
    _, (o4, ob4, ou, obu) = matrix_ranges()
    assert torch.equal(sw[o4:], packed[o4:])
    assert obu + 1 == mlp.DECODER_PACKED


def test_fragment_reads_are_free_of_bank_conflicts():
    """One warp's read of a fragment block: the transposed read (one float a
    lane, for j = 0 and j = 1) hits 32 banks; the forward read (a float2 a
    lane) hits 32 banks in each half-warp.  Unswizzled, the transposed read
    hits 16."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for j in (0, 1):
        f = 16 * t + 8 * j + g
        assert torch.unique(f % 32).numel() == 16
        assert torch.unique(swizzle(f) % 32).numel() == 32
    slot = lane ^ ((lane >> 2) & 4)
    assert torch.equal(swizzle(torch.stack([2 * lane, 2 * lane + 1], 1)),
                       torch.stack([2 * slot, 2 * slot + 1], 1))
    for half in (slice(0, 16), slice(16, 32)):
        banks = torch.stack([2 * slot[half], 2 * slot[half] + 1]) % 32
        assert torch.unique(banks).numel() == 32


@pytest.mark.parametrize("cols,words", [(128, 2), (96, 2)])
def test_mask_bits_round_trip(cols, words):
    """A hidden layer's mask fits ``words`` words a lane (64 bits of a
    128-wide layer, 48 of the 96-wide) and reads back whole."""
    m = torch.as_tensor(np.random.RandomState(cols).rand(64, cols) > 0.5)
    w = mask_words(m)
    assert w.shape == (4, 32, words) and int(w.max()) < 2 ** 32
    assert torch.equal(unmask(w, cols), m)


def test_emulated_vjp_matches_jax_and_float64(models):
    """The emulated kernel against float64 ``decoder_vjp_plain``, the f32
    plain version and ``jax.vjp`` through ``apply_decoder`` (f32, HIGHEST):
    within 1e-3 of each row's largest entry on 99.9 % of the rows."""
    jm, tm = models
    x, g = _refine_rows()
    dx = emulate_vjp(torch.as_tensor(x), torch.as_tensor(g), tm.decoder.packed).numpy()
    ref64 = _float64(x, g, tm.decoder.mats)
    assert dx.shape == (N_ROWS, 32) and np.isfinite(dx).all()
    assert _rows_within(dx, ref64) >= 0.999
    plain = mlp.decoder_vjp_plain(torch.as_tensor(x), torch.as_tensor(g),
                                  tm.decoder.mats).numpy()
    assert _rows_within(dx, plain) >= 0.999
    _, f = jax.vjp(lambda v: jnp.concatenate(
        apply_decoder(jm.decoder_params, jm.decoder_config, v, precision=HI), 1),
        jnp.asarray(x))
    want = np.asarray(f(jnp.asarray(g))[0])
    assert _rows_within(dx, want) >= 0.999
    # most rows hold far tighter than the tolerance
    scale = np.abs(ref64).max(1)
    assert np.median(np.abs(dx - ref64).max(1) / scale) < 1e-5


def test_one_tf32_pass_misses_the_tolerance(models):
    """Control: one TF32 pass per product (hi.hi) misses the row tolerance,
    so the test above tells the three-pass split from one pass."""
    _, tm = models
    x, g = _refine_rows()
    dx = emulate_vjp(torch.as_tensor(x), torch.as_tensor(g), tm.decoder.packed,
                     passes=1).numpy()
    assert _rows_within(dx, _float64(x, g, tm.decoder.mats)) < 0.999
