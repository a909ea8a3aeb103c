"""The selection's gather as one function (``ops.gather.select_gather``)
against the composition it replaced and against the JAX package.

``select_photometric_pixels`` ended in about ten PyTorch ops after the sort
(slice, compare, modulo, division, casts, a (H*W, 4) stack, the (N, 4) row
gather, a transpose); ``select_gather`` does all of it in one kernel on the
card.  Its plain version (the CPU's) must give the old composition's
outputs bitwise, NaN positions included, and the JAX selection's pixels
and values exactly (a selection rounds nothing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.ops import imgproc as JI
from nerf_fusion_tpu_torch.ops import gather, imgproc as TI


def _planes(h, w, seed, ties=False):
    rng = np.random.default_rng(seed)
    inten = rng.random((h, w)).astype(np.float32)
    depth = (1.0 + rng.random((h, w))).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = np.nan
    g = rng.normal(size=(2, h, w)).astype(np.float32)
    if ties:
        g[:, rng.random((h, w)) < 0.8] = 0.0
    g[:, 0, :] = g[:, -1, :] = g[:, :, 0] = g[:, :, -1] = np.nan
    return inten, depth, g


def _before(cur_intensity, cur_depth, cur_dIdxy, k, min_grad_scale, stride):
    """``select_photometric_pixels`` as it was before ``select_gather``."""
    h, w = cur_intensity.shape
    gx, gy = cur_dIdxy[0], cur_dIdxy[1]
    grad2 = gx * gx + gy * gy
    ok = torch.isfinite(grad2) & (grad2 >= min_grad_scale) & torch.isfinite(cur_depth)
    if stride > 1:
        ok = ok & (torch.arange(h)[:, None] % stride == 0) \
            & (torch.arange(w)[None, :] % stride == 0)
    score = torch.where(ok, grad2, torch.full_like(grad2, -1.0)).reshape(-1)
    kk = min(k, ((h - 1) // stride + 1) * ((w - 1) // stride + 1))
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:kk], idx[:kk]
    valid = vals >= 0.0
    u = (idx % w).to(torch.float32)
    v = (idx // w).to(torch.float32)
    rows = torch.stack([cur_intensity.reshape(-1), cur_depth.reshape(-1),
                        gx.reshape(-1), gy.reshape(-1)], dim=-1)
    cols = gather.row_gather(rows, idx.to(torch.int32)).T.contiguous()
    return u, v, cols[0], cols[1], cols[2], cols[3], valid


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(np.isnan(a), np.isnan(b)) if a.dtype.kind == "f" else True
    assert np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)]) if a.dtype.kind == "f" \
        else np.array_equal(a, b)


@pytest.mark.parametrize("h,w,k,stride,ties", [(48, 64, 700, 2, False),
                                               (48, 64, 700, 2, True),
                                               (61, 83, 2000, 1, True),
                                               (30, 40, 10 ** 6, 2, False)])
def test_selection_is_the_composition_before_and_jax(h, w, k, stride, ties):
    planes = _planes(h, w, h + k, ties)
    t = tuple(torch.from_numpy(p) for p in planes)
    n0 = gather.select_gather.launches
    now = TI.select_photometric_pixels(*t, k, 0.0, stride=stride)
    assert gather.select_gather.launches == n0          # the CPU's plain version
    for a, b in zip(now, _before(*t, k, 0.0, stride)):
        assert a.is_contiguous()
        _same(a.numpy(), b.numpy())
    jax_pix = JI.select_photometric_pixels(*(jnp.asarray(p) for p in planes), k, 0.0,
                                           stride=stride)
    for a, b in zip(now, jax_pix):
        _same(a.numpy(), np.asarray(b))
    assert 0 < int(now[6].sum()) <= len(now[6])


def test_select_gather_clips_and_takes_a_prefix():
    """Indices outside the plane are clipped (``jnp.take(mode="clip")``),
    only the first kk entries are read, kk = 0 gives empty vectors."""
    planes = tuple(torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * c
                   for c in range(4))
    vals = torch.tensor([3.0, 0.0, -1.0, 2.0] + [9.0] * 8)
    idx = torch.tensor([5, 11, 0, 7] + list(range(8)))
    u, v, i1, d1, gx, gy, valid = gather.select_gather(vals, idx, 4, 4, planes)
    assert u.tolist() == [1.0, 3.0, 0.0, 3.0] and v.tolist() == [1.0, 2.0, 0.0, 1.0]
    assert i1.tolist() == [5.0, 11.0, 0.0, 7.0] and gy.tolist() == [305.0, 311.0, 300.0, 307.0]
    assert valid.tolist() == [True, True, False, True]
    clipped = gather.select_gather(vals, torch.tensor([-3, 40] + list(range(10))), 2, 4,
                                   planes)
    assert clipped[2].tolist() == [0.0, 11.0]
    assert all(x.numel() == 0 for x in gather.select_gather(vals, idx, 0, 4, planes))


def test_select_gather_rejects_bad_operands():
    planes = tuple(torch.zeros(3, 4) for _ in range(4))
    vals, idx = torch.zeros(12), torch.arange(12)
    for bad in ((vals.double(), idx, 4, 4, planes), (vals, idx.int(), 4, 4, planes),
                (vals, idx, 13, 4, planes), (vals, idx, 4, 3, planes),
                (vals, idx, 4, 4, planes[:3]), (vals, idx[:6], 4, 4, planes),
                (vals, idx.to("meta"), 4, 4, planes)):
        with pytest.raises(ValueError):
            gather.select_gather(*bad)
