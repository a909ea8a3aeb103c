"""Port's windowed stencils (plain path on the CPU) against the JAX package.

Mirrors ``test_pallas_stencil.py``: counts exact on the valid pixels of a
synthetic frame (the kernels count the centre, the reference's
``radius_neighbor_count`` does not), normals |n.n_ref| > 0.999 on 99 % of
the valid pixels, heights that are no multiple of a tile, and an
all-invalid frame.  The reference's window wraps around the image border
(``jnp.roll``) where the port's pads with invalid pixels; on these frames
no wrapped neighbour lies within the radius, so the counts agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.ops import imgproc as jimg
from nerf_fusion_tpu.ops.pallas_stencil import (TILE_H, neighbor_count_pallas,
                                                normals_stencil_pallas)
from nerf_fusion_tpu_torch.ops import imgproc, stencil


def _frame(h=120, w=160):
    fr = SyntheticSequence(n_frames=1, width=w, height=h).render_frame(0)
    depth = jnp.asarray(fr.depth)
    pts = jimg.unproject_depth(depth, fr.calib.fx, fr.calib.fy, fr.calib.cx, fr.calib.cy)
    valid = jnp.isfinite(depth)
    pts = jnp.where(valid[None], pts, 0.0)
    return (pts, valid), (torch.as_tensor(np.asarray(pts)),
                          torch.as_tensor(np.asarray(valid)))


def _agree(n_ref, n_port, mask):
    nr = np.asarray(n_ref)[:, mask].T
    npt = np.asarray(n_port)[:, mask].T
    dot = np.sum(nr * npt, -1)
    assert np.mean(np.abs(dot) > 0.999) > 0.99
    assert np.mean(dot > 0) > 0.995


def test_normals_stencil_matches_xla():
    (pj, vj), (pt, vt) = _frame()
    n_ref, ok = jimg.estimate_normals_image(pj, vj, radius=0.1, radius_px=3,
                                            min_neighbors=5)
    cnt_ref = jimg.radius_neighbor_count(pj, vj, radius=0.1, radius_px=3)
    n_t, cnt_t = stencil.normals_stencil(pt, vt, radius=0.1)
    _agree(n_ref, n_t.numpy(), np.asarray(ok))
    dc = cnt_t.numpy() - 1.0 - np.asarray(cnt_ref)
    assert np.abs(dc[np.asarray(vj)]).max() == 0.0


def test_normals_stencil_matches_pallas_interpret():
    (pj, vj), (pt, vt) = _frame()
    n_pal, cnt_pal = normals_stencil_pallas(pj, vj, radius=0.1, interpret=True)
    n_t, cnt_t = stencil.normals_stencil(pt, vt, radius=0.1)
    m = np.asarray(vj) & (np.asarray(cnt_pal) >= 6)
    _agree(n_pal, n_t.numpy(), m)
    assert np.array_equal(cnt_t.numpy()[np.asarray(vj)], np.asarray(cnt_pal)[np.asarray(vj)])


def test_count_only_matches_xla_and_pallas():
    (pj, vj), (pt, vt) = _frame()
    cnt_ref = jimg.radius_neighbor_count(pj, vj, radius=0.05, radius_px=3)
    cnt_pal = neighbor_count_pallas(pj, vj, radius=0.05, interpret=True)
    cnt_t = stencil.neighbor_count(pt, vt, radius=0.05).numpy()
    v = np.asarray(vj)
    assert np.abs((cnt_t - 1.0 - np.asarray(cnt_ref))[v]).max() == 0.0
    assert np.array_equal(cnt_t[v], np.asarray(cnt_pal)[v])
    # the excluded-centre form the frontend gates on
    excl = imgproc.radius_neighbor_count(pt, vt, radius=0.05).numpy()
    assert np.array_equal(excl[v], np.asarray(cnt_ref)[v])


@pytest.mark.parametrize("h", [TILE_H - 7, TILE_H, TILE_H + 1, 3 * TILE_H])
def test_nonmultiple_heights(h):
    (pj, vj), (pt, vt) = _frame(h=h, w=96)
    cnt_ref = jimg.radius_neighbor_count(pj, vj, radius=0.1, radius_px=3)
    n_t, cnt_t = stencil.normals_stencil(pt, vt, radius=0.1)
    assert n_t.shape == (3, h, 96) and cnt_t.shape == (h, 96)
    dc = (cnt_t.numpy() - 1.0 - np.asarray(cnt_ref))[np.asarray(vj)]
    assert np.abs(dc).max() == 0.0


def test_all_invalid_frame():
    pts = torch.zeros((3, 72, 96))
    valid = torch.zeros((72, 96), dtype=torch.bool)
    n, cnt = stencil.normals_stencil(pts, valid, radius=0.1)
    assert torch.all(cnt == 0.0)
    assert torch.all(torch.isfinite(n))
    assert torch.all(stencil.neighbor_count(pts, valid, radius=0.05) == 0.0)


def test_estimate_normals_image_matches_xla():
    (pj, vj), (pt, vt) = _frame()
    n_ref, ok_ref = jimg.estimate_normals_image(pj, vj, radius=0.1, radius_px=3,
                                                min_neighbors=5)
    n_t, ok_t = imgproc.estimate_normals_image(pt, vt, radius=0.1, min_neighbors=5)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_ref))
    _agree(n_ref, n_t.numpy(), np.asarray(ok_ref))


def test_wrapper_rejects_bad_operands():
    (_, _), (pt, vt) = _frame()
    with pytest.raises(ValueError):
        stencil.normals_stencil(pt.double(), vt)
    with pytest.raises(ValueError):
        stencil.neighbor_count(pt, vt.float())
