"""The frontend's fused point-cloud stage (``stencil.frontend_points``; the
plain version on the CPU) against the composition it replaced, the JAX
package, and a plain-PyTorch emulation of the kernel's tiling.

Tolerances: points within 1e-6 of the JAX package's (bitwise against the
port's own earlier composition), the final mask equal pixel for pixel
(against the JAX package on the pixels at least 6 from the border: its XLA
window wraps around the image where the port's pads with invalid pixels),
normals |n.n_ref| > 0.999 on at least 99 % of the masked pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.ops import imgproc as jimg
from nerf_fusion_tpu.ops.pallas_stencil import neighbor_count_pallas, normals_stencil_pallas
from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
from nerf_fusion_tpu_torch.ops import imgproc, stencil
from nerf_fusion_tpu_torch.tools import preprocess_probe

GATES = (0.05, 16, 0.1, 5)          # the frontend's defaults, for 320x240
COARSE = (0.12, 16, 0.2, 5)         # the same gates at a 160x120 pixel pitch


def _rendered(h, w, frame=0):
    """Depth of a rendered room frame (NaN where cut) and its intrinsics."""
    fr = SyntheticSequence(n_frames=4, width=w, height=h).render_frame(frame)
    d = torch.where((fr.depth < 0.5) | (fr.depth > 5.0), torch.nan, fr.depth)
    c = fr.calib
    return d.contiguous(), (c.fx, c.fy, c.cx, c.cy)


def _probe_depth():
    _, depth = preprocess_probe.synthetic_frame()
    k = preprocess_probe
    return (imgproc.resize_half_nearest(torch.as_tensor(depth)),
            (k.FX * 0.5, k.FY * 0.5, k.CX * 0.5, k.CY * 0.5))


def _earlier_composition(pc_depth, fx, fy, cx, cy, outlier_radius, outlier_min_nb,
                         normal_radius, normal_min_nb):
    """The point-cloud stage as ``preprocess_frame`` spelled it out before
    ``frontend_points`` existed."""
    pts = imgproc.unproject_depth(pc_depth, fx, fy, cx, cy)
    valid = torch.isfinite(pc_depth)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts))
    ncount = stencil.neighbor_count(pts0, valid, outlier_radius) - valid.to(torch.float32)
    valid = valid & (ncount >= outlier_min_nb)
    normals, cnt = stencil.normals_stencil(pts0, valid, normal_radius)
    nvalid = valid & (cnt >= normal_min_nb + 1) & torch.isfinite(torch.sum(normals, dim=0))
    normals = torch.where(nvalid[None], normals, torch.zeros_like(normals))
    valid = valid & nvalid
    return pts0, normals, valid


def _jax_composition(depth, k, gates, pallas=False):
    """The JAX frontend's point-cloud stage on the same depth, through its
    XLA functions or the Pallas kernels in interpret mode."""
    ro, mo, rn, mn = gates
    d = jnp.asarray(depth.numpy())
    pts = jimg.unproject_depth(d, *k)
    valid = jnp.isfinite(d)
    pts0 = jnp.where(valid[None], pts, 0.0)
    if pallas:
        ncount = neighbor_count_pallas(pts0, valid, radius=ro, interpret=True) - valid
        valid = valid & (ncount >= mo)
        normals, cnt = normals_stencil_pallas(pts0, valid, radius=rn, interpret=True)
        nvalid = valid & (cnt >= mn + 1) & jnp.isfinite(jnp.sum(normals, axis=0))
        normals = jnp.where(nvalid[None], normals, 0.0)
    else:
        ncount = jimg.radius_neighbor_count(pts0, valid, radius=ro, radius_px=3)
        valid = valid & (ncount >= mo)
        normals, nvalid = jimg.estimate_normals_image(pts0, valid, radius=rn, radius_px=3,
                                                      min_neighbors=mn)
    return np.asarray(pts0), np.asarray(normals), np.asarray(valid & nvalid)


def _hold_against_jax(out, ref):
    pts, nrm, valid = (t.numpy() for t in out)
    pts_r, nrm_r, valid_r = ref
    assert np.abs(pts - pts_r).max() <= 1e-6
    assert np.array_equal(valid[6:-6, 6:-6], valid_r[6:-6, 6:-6])
    m = valid & valid_r
    assert m.sum() > 0.3 * m.size
    dot = np.abs(np.sum(nrm * nrm_r, 0))[m]
    assert np.mean(dot > 0.999) >= 0.99
    assert np.all(nrm[:, ~valid] == 0.0)


@pytest.mark.parametrize("case", ["rendered_120x160", "rendered_240x320", "probe_240x320"])
def test_plain_equals_the_earlier_composition_bitwise(case):
    if case == "probe_240x320":
        (d, k), gates = _probe_depth(), GATES
    else:
        h, w = (int(v) for v in case.split("_")[1].split("x"))
        d, k = _rendered(h, w)
        gates = GATES if h == 240 else COARSE
    out = stencil.frontend_points_plain(d, *k, *gates)
    ref = _earlier_composition(d, *k, *gates)
    assert out[2].dtype == torch.bool and int(out[2].sum()) > 0.3 * d.numel()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the wrapper takes the plain version for a CPU tensor
    for a, b in zip(stencil.frontend_points(d, *k, *gates), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_matches_the_jax_frontend(pallas):
    d, k = _rendered(120, 160)
    _hold_against_jax(stencil.frontend_points(d, *k, *COARSE),
                      _jax_composition(d, k, COARSE, pallas=pallas))


def test_matches_the_jax_frontend_at_the_main_path_shape():
    d, k = _rendered(240, 320, frame=1)
    _hold_against_jax(stencil.frontend_points(d, *k, *GATES), _jax_composition(d, k, GATES))


@pytest.mark.parametrize("outlier_min_nb", [0, 16])
@pytest.mark.parametrize("normal_min_nb", [0, 5])
def test_gates_match_the_jax_frontend(outlier_min_nb, normal_min_nb):
    d, k = _rendered(120, 160, frame=2)
    gates = (COARSE[0], outlier_min_nb, COARSE[2], normal_min_nb)
    out = stencil.frontend_points(d, *k, *gates)
    _hold_against_jax(out, _jax_composition(d, k, gates))
    # a looser gate keeps every pixel of the default one
    strict = stencil.frontend_points(d, *k, *COARSE)[2]
    assert bool((out[2] | ~strict).all())
    if outlier_min_nb == 0 and normal_min_nb == 0:
        assert torch.equal(out[2], torch.isfinite(d))


def _tiled(depth, k, gates, ty, tx, halo):
    """The kernel's tiling in plain PyTorch: each tile runs the whole stage
    on its own crop (the tile plus ``halo`` pixels, cut at the image) and
    keeps its own pixels."""
    H, W = depth.shape
    fx, fy, cx, cy = k
    pts = torch.zeros((3, H, W))
    nrm = torch.zeros((3, H, W))
    valid = torch.zeros((H, W), dtype=torch.bool)
    for y0 in range(0, H, ty):
        for x0 in range(0, W, tx):
            ya, xa = max(y0 - halo, 0), max(x0 - halo, 0)
            yb, xb = min(y0 + ty + halo, H), min(x0 + tx + halo, W)
            p, n, v = stencil.frontend_points_plain(depth[ya:yb, xa:xb], fx, fy,
                                                    cx - xa, cy - ya, *gates)
            y1, x1 = min(y0 + ty, H), min(x0 + tx, W)
            own = (slice(y0 - ya, y1 - ya), slice(x0 - xa, x1 - xa))
            pts[:, y0:y1, x0:x1] = p[(slice(None),) + own]
            nrm[:, y0:y1, x0:x1] = n[(slice(None),) + own]
            valid[y0:y1, x0:x1] = v[own]
    return pts, nrm, valid


@pytest.mark.parametrize("tile", [(16, 16), (8, 32), (16, 32), (20, 32)],
                         ids=["16x16", "32x8", "32x16", "32x20"])
@pytest.mark.parametrize("shape", [(61, 47), (120, 160)], ids=["61x47", "120x160"])
def test_tiles_with_a_6_pixel_halo_give_the_whole_image_exactly(tile, shape):
    d, k = _rendered(*shape)
    gates = COARSE if shape[0] == 120 else (0.3, 16, 0.5, 5)
    whole = stencil.frontend_points_plain(d, *k, *gates)
    assert int(whole[2].sum()) > 0.3 * d.numel()
    for a, b in zip(_tiled(d, k, gates, *tile, halo=6), whole):
        assert torch.equal(a, b)


def test_a_3_pixel_halo_is_not_enough():
    """Control: a normal 3 pixels inside a tile reads gates 3 pixels
    outside it, whose counts reach 3 further."""
    d, k = _rendered(120, 160)
    whole = stencil.frontend_points_plain(d, *k, *COARSE)
    pts, nrm, valid = _tiled(d, k, COARSE, 16, 16, halo=3)
    assert torch.equal(pts, whole[0])
    assert not (torch.equal(valid, whole[2]) and torch.equal(nrm, whole[1]))


def test_all_nan_depth():
    d = torch.full((48, 64), float("nan"))
    pts, nrm, valid = stencil.frontend_points(d, 60.0, 60.0, 31.5, 23.5, *GATES)
    assert not valid.any() and torch.all(pts == 0) and torch.all(nrm == 0)


def test_flat_wall_without_invalid_pixels():
    d = torch.full((48, 64), 2.0)
    pts, nrm, valid = stencil.frontend_points(d, 300.0, 300.0, 31.5, 23.5, *GATES)
    assert torch.all(pts[2] == 2.0)
    # 3 pixels from the border a window holds 28 pixels, at a corner 16
    assert valid[3:-3, 3:-3].all() and not valid[0, 0]
    inner = nrm[:, 3:-3, 3:-3]
    assert torch.all(inner[2] < -0.999)


def test_wrapper_contract():
    d, k = _rendered(61, 47)
    with pytest.raises(ValueError):
        stencil.frontend_points(d.double(), *k, *GATES)
    with pytest.raises(ValueError):
        stencil.frontend_points(d[None], *k, *GATES)
    with pytest.raises(ValueError):
        stencil.frontend_points(d.to("meta"), *k, *GATES)
    before = (stencil.frontend_points.launches, stencil.neighbor_count.launches,
              stencil.normals_stencil.launches)
    stencil.frontend_points(d, *k, *GATES)
    assert before == (stencil.frontend_points.launches, stencil.neighbor_count.launches,
                      stencil.normals_stencil.launches)
