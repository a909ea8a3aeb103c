"""Port's gather wrappers (plain path) against JAX's gathers.

The plain versions must equal ``jnp.take(..., mode="clip")`` and
``jnp.take_along_axis(axis=1)`` exactly, NaN positions included (a gather
moves values and rounds nothing, so the tolerance is 0).  At a small size
they are also held against the probes' ``pallas_call`` bodies
(``tools/gather_exp3.py:88,115``, ``tools/gather_exp4.py:72``) rebuilt here
in interpret mode.  The kernels themselves are held against the plain
versions on the card (``test_torch_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_fusion_tpu_torch.ops import gather


def _rows(rng, n, c):
    shape = (n,) if c == 1 else (n, c)
    rows = rng.normal(size=shape).astype(np.float32)
    rows.reshape(n, -1)[rng.integers(0, n, 5)] = np.nan
    return rows


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


def _lane_indices(rng, h, b):
    """Mostly in range; some negative (wrap once), some >= B or < -B."""
    idx = rng.integers(0, b, (h, b))
    pick = rng.random((h, b))
    idx = np.where(pick < 0.1, -rng.integers(1, b + 1, (h, b)), idx)
    idx = np.where((pick >= 0.1) & (pick < 0.13), b + rng.integers(0, 7, (h, b)), idx)
    idx = np.where((pick >= 0.13) & (pick < 0.15), -b - 1 - rng.integers(0, 7, (h, b)),
                   idx)
    return idx.astype(np.int32)


@pytest.mark.parametrize("c", [1, 2, 4])
def test_row_gather_plain_matches_jnp_take_clip(c):
    rng = np.random.default_rng(c)
    n, m = 1000, 3000
    rows = _rows(rng, n, c)
    idx = rng.integers(-50, n + 50, m).astype(np.int32)     # some out of range
    got = gather.row_gather(torch.tensor(rows), torch.tensor(idx))
    _same(got.numpy(), jnp.take(jnp.asarray(rows), jnp.asarray(idx), axis=0, mode="clip"))


@pytest.mark.parametrize("b", [96, 320])
def test_lane_gather_plain_matches_take_along_axis(b):
    rng = np.random.default_rng(b)
    h = 40
    src = rng.normal(size=(h, b)).astype(np.float32)
    src[3, 7] = np.nan
    idx = _lane_indices(rng, h, b)
    got = gather.lane_gather(torch.tensor(src), torch.tensor(idx))
    ref = jnp.take_along_axis(jnp.asarray(src), jnp.asarray(idx), axis=1)
    assert np.isnan(np.asarray(ref)).sum() > h        # the out-of-range rule is exercised
    _same(got.numpy(), ref)


@pytest.mark.parametrize("c", [1, 2])
def test_row_gather_matches_pallas_probe_interpret(c):
    """``pallas_gather`` (C = 2) and ``pallas_gather1`` (C = 1): the source
    pinned whole, the indices in chunks, clip mode."""
    rng = np.random.default_rng(10 + c)
    s, ch = 512, 128
    rows = _rows(rng, s, c)
    idx = np.clip(np.arange(s) + rng.integers(-40, 41, s), -3, s + 3).astype(np.int32)
    src_spec = (pl.BlockSpec((s,), lambda g: (0,)) if c == 1
                else pl.BlockSpec((s, c), lambda g: (0, 0)))
    out_spec = (pl.BlockSpec((ch,), lambda g: (g,)) if c == 1
                else pl.BlockSpec((ch, c), lambda g: (g, 0)))

    def kern(idx_ref, src_ref, out_ref):
        out_ref[...] = jnp.take(src_ref[...], idx_ref[...], axis=0, mode="clip")

    ref = pl.pallas_call(
        kern, grid=(s // ch,), in_specs=[pl.BlockSpec((ch,), lambda g: (g,)), src_spec],
        out_specs=out_spec, out_shape=jax.ShapeDtypeStruct(rows.shape, jnp.float32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(rows))
    _same(gather.row_gather(torch.tensor(rows), torch.tensor(idx)).numpy(), ref)


def test_lane_gather_matches_pallas_probe_interpret():
    """``lane_gather`` of gather_exp4.py: 32 rows per block."""
    rng = np.random.default_rng(7)
    h, b, rpb = 64, 256, 32
    src = rng.normal(size=(h, b)).astype(np.float32)
    idx = _lane_indices(rng, h, b)

    def kern(src_ref, idx_ref, out_ref):
        out_ref[...] = jnp.take_along_axis(src_ref[...], idx_ref[...], axis=1)

    spec = pl.BlockSpec((rpb, b), lambda g: (g, 0))
    ref = pl.pallas_call(kern, grid=(h // rpb,), in_specs=[spec, spec], out_specs=spec,
                         out_shape=jax.ShapeDtypeStruct((h, b), jnp.float32),
                         interpret=True)(jnp.asarray(src), jnp.asarray(idx))
    _same(gather.lane_gather(torch.tensor(src), torch.tensor(idx)).numpy(), ref)


def test_cpu_gathers_count_no_launch_and_bad_operands_raise():
    before = (dict(gather.row_gather.launches_by_c), gather.lane_gather.launches)
    rows = torch.randn(10, 2)
    idx = torch.tensor([0, 9, 12, -1], dtype=torch.int32)
    assert torch.equal(gather.row_gather(rows, idx), rows[[0, 9, 9, 0]])
    gather.lane_gather(torch.randn(3, 8), torch.zeros(3, 8, dtype=torch.int32))
    assert (gather.row_gather.launches_by_c, gather.lane_gather.launches) == before
    with pytest.raises(ValueError):
        gather.row_gather(torch.randn(10, 3), idx)                 # width 3
    with pytest.raises(ValueError):
        gather.row_gather(rows, idx.long())                        # int64 indices
    with pytest.raises(ValueError):
        gather.row_gather(rows.double(), idx)
    with pytest.raises(ValueError):
        gather.row_gather(torch.empty(0, 2), idx)
    with pytest.raises(ValueError):
        gather.row_gather(torch.randn(10, 2, device="meta"),
                          torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        gather.lane_gather(torch.randn(3, 8), torch.zeros(3, 7, dtype=torch.int32))
    assert gather.row_gather(rows, torch.zeros(0, dtype=torch.int32)).shape == (0, 2)
