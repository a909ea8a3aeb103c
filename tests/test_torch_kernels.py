"""The CUDA kernels against their plain versions (card only), and the
wrappers' device contract (here too).

Tests marked ``cuda`` need an NVIDIA GPU and skip without one: a CUDA
kernel has no CPU mode.  On the card run them with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(``tests/conftest.py`` imports jax, which the port does not need).
"""

from pathlib import Path

import pytest
import torch

from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import (cuda_build, gather, imgproc, mlp, photometric, sdf_term,
                                       stencil)
from nerf_fusion_tpu_torch.system.tracker import _intrinsics
from nerf_fusion_tpu_torch.tools.preprocess_probe import (frontend_mismatch, frontend_ok,
                                                          normal_agreement)
from nerf_fusion_tpu_torch.utils import se3_torch as st
from nerf_fusion_tpu_torch.utils.timing import per_call

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    m, _ = load_model(CKPT, 300)
    return m


def _points(device, h=61, w=83, seed=0):
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    z = 1.5 + 0.3 * torch.sin(xx / 9.0) + 0.01 * torch.rand(h, w, generator=g)
    pts = torch.stack([(xx - w / 2) / 80.0 * z, (yy - h / 2) / 80.0 * z, z])
    valid = torch.rand(h, w, generator=g) > 0.1
    pts = torch.where(valid[None], pts, torch.zeros_like(pts))
    return pts.float().to(device), valid.to(device)


def _depth(device, h, w, seed=0, nan=0.1):
    """A smooth depth with a step edge, sensor-like noise and a ``nan`` share
    of invalid pixels, and intrinsics at the main path's pixel pitch."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    z = 1.5 + 0.3 * torch.sin(xx / 40.0) + 0.4 * ((xx > w // 2) & (yy > h // 3)) \
        + 0.004 * torch.rand(h, w, generator=g)
    z[torch.rand(h, w, generator=g) < nan] = float("nan")
    return z.float().to(device), (240.0, 241.5, (w - 1) / 2.0, (h - 1) / 2.0)


def _photometric_case(device, h=61, w=83, stride=2, sparse=0, seed=0, nan_depth=0.1,
                      robust="huber"):
    """A previous and a current level of a smooth scene, NaN depths at a
    ``nan_depth`` share of the current pixels, a pose that warps some pixels
    out of the image; the dense term, or a ``sparse``-pixel selection."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")

    def planes(shift):
        inten = 0.5 + 0.4 * torch.sin((xx + shift) / 5.0) * torch.cos(yy / 7.0)
        depth = 1.5 + 0.3 * torch.sin((xx + shift) / 9.0) + 0.005 * torch.rand(h, w, generator=g)
        return inten, depth

    i0, d0 = planes(0.0)
    i1, d1 = planes(1.5)
    d1[torch.rand(h, w, generator=g) < nan_depth] = float("nan")
    grad = imgproc.gradient_xy(i1)
    fx = fy = 0.8 * w
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    R, t = st.se3_exp(torch.tensor([0.03, -0.02, 0.02, 0.01, 0.04, -0.005]))
    K, Kinv = _intrinsics(fx, fy, cx, cy, "cpu")
    krkinv, kt = K @ R @ Kinv, K @ t
    if sparse:
        level = photometric.Sparse(w, h, imgproc.select_photometric_pixels(
            i1, d1, grad, sparse, 1e-5, stride=stride))
    else:
        level = photometric.Dense(i1, d1, grad)
    if device != "cpu":
        level = level._replace(pix=tuple(p.to(device) for p in level.pix)) if sparse \
            else photometric.Dense(*(p.to(device) for p in level))
    args = (imgproc.intensity_depth_rows(i0, d0).to(device), level, krkinv.to(device),
            kt.to(device), fx, fy, cx, cy)
    kw = dict(min_grad_scale=1e-5, max_depth_delta=0.2, stride=stride, robust_kernel=robust,
              robust_k=0.05, rgb_weight=500.0)
    return args, kw


def test_cpu_tensors_take_the_plain_path_and_count_nothing(model):
    def counts():
        return (mlp.decoder_forward.launches, mlp.decoder_forward_grad.launches,
                mlp.encoder_forward.launches, stencil.normals_stencil.launches,
                stencil.neighbor_count.launches, stencil.frontend_points.launches,
                photometric.photometric_hg.launches)

    before = counts()
    x = torch.randn(40, 32)
    assert torch.equal(mlp.decoder_forward(x, model.decoder.packed, model.decoder.mats),
                       mlp.decoder_forward_plain(x, model.decoder.mats))
    mlp.decoder_forward_grad(x, model.decoder.packed, model.decoder.mats)
    mlp.encoder_forward(torch.randn(40, 6), model.encoder.packed, model.encoder.mats)
    pts, valid = _points("cpu")
    stencil.normals_stencil(pts, valid, 0.1)
    stencil.neighbor_count(pts, valid, 0.05)
    depth, k = _depth("cpu", 61, 47)
    for a, b in zip(stencil.frontend_points(depth, *k),
                    stencil.frontend_points_plain(depth, *k)):
        assert torch.equal(a, b)
    for sparse in (0, 500):
        args, kw = _photometric_case("cpu", sparse=sparse)
        for a, b in zip(photometric.photometric_hg(*args, **kw),
                        photometric.photometric_hg_plain(*args, **kw)):
            assert torch.equal(a, b)
    assert counts() == before


def test_wrappers_reject_bad_operands(model):
    dec = model.decoder
    with pytest.raises(ValueError):
        mlp.decoder_forward(torch.randn(8, 31), dec.packed, dec.mats)
    with pytest.raises(ValueError):
        mlp.decoder_forward(torch.randn(32, 8).T, dec.packed, dec.mats)
    with pytest.raises(ValueError):
        mlp.encoder_forward(torch.randn(8, 6).double(), model.encoder.packed,
                            model.encoder.mats)
    with pytest.raises(ValueError):
        mlp.decoder_forward(torch.randn(8, 32, device="meta"), dec.packed, dec.mats)
    (rows, level, krkinv, kt, *intr), kw = _photometric_case("cpu")
    bad = [((rows, tuple(level), krkinv, kt, *intr), kw),           # not Dense / Sparse
           ((rows[:-1], level, krkinv, kt, *intr), kw),             # source of another size
           ((rows, level._replace(depth=level.depth.T), krkinv, kt, *intr), kw),
           ((rows, level, krkinv.double(), kt, *intr), kw),
           ((rows, level, krkinv.to("meta"), kt, *intr), kw),       # mixed devices
           ((rows, level, krkinv, kt, *intr), {**kw, "stride": 0})]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            photometric.photometric_hg(*args, **kwargs)
    with pytest.raises(NotImplementedError):
        photometric.photometric_hg(rows, level, krkinv, kt, *intr,
                                   **{**kw, "robust_kernel": "cauchy"})


def test_per_call_reads_a_trace_that_lost_events():
    """100 launches of one 4.1 us kernel, all events or only 87 of them: the
    same time per call; whole multiples of the calls are summed as before."""
    full, k = per_call([4.1] * 100, 100)
    lost, k_lost = per_call([4.1] * 87, 100)
    assert (k, k_lost) == (1, 1) and abs(full - 4.1e-3) < 1e-9 and abs(lost - full) < 1e-9
    ms, k = per_call([1.0, 3.0] * 20, 20)
    assert k == 2 and abs(ms - 4.0e-3) < 1e-12
    ms, k = per_call([2.0] * 2987, 20)          # 13 of 3000 events lost
    assert k == 150 and abs(ms - 0.3) < 1e-9


def test_build_flags_target_hopper():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu")) == sorted(
        cuda_build.SOURCES)
    assert cuda_build.library_path("mlp").parent == cuda_build.BUILD_DIR


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 3001, 8192, 262144])
def test_decoder_kernels_match_plain(cuda_device, model, n):
    """Both variants at ragged sizes (the forward tile holds 16 points, the
    gradient tile 4), the tracker's 8192 and the mesher's chunk."""
    dec = model.decoder.to(cuda_device)
    x = (0.4 * torch.randn(n, 32, generator=torch.Generator().manual_seed(n))).to(cuda_device)
    n0 = mlp.decoder_forward.launches
    out = mlp.decoder_forward(x, dec.packed, dec.mats)
    assert mlp.decoder_forward.launches == n0 + 1
    torch.testing.assert_close(out, mlp.decoder_forward_plain(x, dec.mats),
                               atol=1e-4, rtol=0)
    out, grad = mlp.decoder_forward_grad(x, dec.packed, dec.mats)
    ref, gref = mlp.decoder_forward_grad_plain(x, dec.mats)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    # a ReLU input within rounding of 0 may flip: hold 99.9 % of the rows
    ok = ((grad - gref).abs().amax(1) <= 1e-3).float().mean()
    assert ok >= 0.999


def _vjp_rows_within(dx, ref, tol=1e-3):
    """Share of rows whose dx is within ``tol`` of the row's largest |entry|
    of the plain version (a ReLU input within rounding of 0 may flip)."""
    scale = ref.abs().amax(1).clamp_min(1e-30)
    return float(((dx - ref).abs().amax(1) <= tol * scale).float().mean())


def test_decoder_vjp_on_cpu_is_the_plain_version_and_counts_nothing(model):
    dec = model.decoder
    gen = torch.Generator().manual_seed(3)
    x, g = 0.4 * torch.randn(70, 32, generator=gen), torch.randn(70, 2, generator=gen)
    n0 = mlp.decoder_vjp.launches
    assert torch.equal(mlp.decoder_vjp(x, g, dec.packed, dec.mats),
                       mlp.decoder_vjp_plain(x, g, dec.mats))
    xr = x.clone().requires_grad_()
    (dec.differentiable(xr) * g).sum().backward()
    assert torch.equal(xr.grad, mlp.decoder_vjp_plain(x, g, dec.mats))
    assert mlp.decoder_vjp.launches == n0
    for bad_g in (g[:, :1], g.double(), g.T.contiguous().T):
        with pytest.raises(ValueError):
            mlp.decoder_vjp(x, bad_g, dec.packed, dec.mats)
    for bad_packed in (dec.packed[:-1], dec.packed.double(), model.encoder.packed):
        with pytest.raises(ValueError):
            mlp.decoder_vjp(x, g, bad_packed, dec.mats)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 65, 5000, 132 * 8 * 16 + 16 * 37 + 5,
                               327680])
def test_decoder_vjp_kernel_matches_plain(cuda_device, model, n):
    """Ragged sizes (a warp takes 16-row tiles, 8 warps a block, one block
    an SM; 17493 rows give the 132 blocks' warps a second round and end on a
    partial tile) up to the refinement's 8 x 40960 rows: dx within 1e-3 of
    each row's largest entry on 99.9 % of the rows; one launch counted."""
    dec = model.decoder.to(cuda_device)
    gen = torch.Generator().manual_seed(n)
    x = (0.4 * torch.randn(n, 32, generator=gen)).to(cuda_device)
    g = torch.randn(n, 2, generator=gen).to(cuda_device)
    n0 = mlp.decoder_vjp.launches
    dx = mlp.decoder_vjp(x, g, dec.packed, dec.mats)
    assert mlp.decoder_vjp.launches == n0 + 1
    assert _vjp_rows_within(dx, mlp.decoder_vjp_plain(x, g, dec.mats)) >= 0.999


@pytest.mark.cuda
def test_decoder_fn_autograd_on_card_matches_cpu(cuda_device, model):
    """A latent buffer through a gather and ``DecoderFn`` under autograd:
    the card's gradient against the CPU's, within 1e-3 of each row's
    largest entry on 99.9 % of the rows; the backward launches the kernel."""
    gen = torch.Generator().manual_seed(5)
    lat = 0.3 * torch.randn(500, 29, generator=gen)
    slot = torch.randint(0, 500, (8000,), generator=gen)
    pos = torch.rand(8000, 3, generator=gen) - 0.5
    w = torch.randn(8000, 2, generator=gen)
    grads = []
    for dev in ("cpu", cuda_device):
        dec = model.decoder.to(dev)
        lat_d = lat.to(dev, copy=True).requires_grad_()
        x = torch.cat([lat_d[slot.to(dev)], pos.to(dev)], 1)
        n0 = mlp.decoder_vjp.launches
        (dec.differentiable(x) * w.to(dev)).sum().backward()
        assert mlp.decoder_vjp.launches == n0 + (dev != "cpu")
        grads.append(lat_d.grad.cpu())
    assert _vjp_rows_within(grads[1], grads[0]) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 5000, 327680])
def test_encoder_kernel_matches_plain(cuda_device, model, n):
    """Ragged sizes (a tile holds 16 rows) up to the integrate call's
    8 x 40960 rows; one launch counted."""
    enc = model.encoder.to(cuda_device)
    x = torch.randn(n, 6, generator=torch.Generator().manual_seed(n)).to(cuda_device)
    n0 = mlp.encoder_forward.launches
    out = mlp.encoder_forward(x, enc.packed, enc.mats)
    assert mlp.encoder_forward.launches == n0 + 1
    torch.testing.assert_close(out, mlp.encoder_forward_plain(x, enc.mats), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,stride,sparse,nan_depth,robust", [
    (61, 83, 1, 0, 0.1, "huber"),        # dense, stride 1, ragged grid
    (61, 83, 2, 0, 0.1, "tukey"),        # dense, stride 2 (31 x 42 pixels)
    (240, 320, 2, 0, 0.02, None),
    (480, 640, 2, 0, 0.02, "huber"),     # the loop's level 0
    (61, 83, 2, 1001, 0.1, "huber"),     # sparse, ragged count
    (480, 640, 2, 24576, 0.02, None),    # the fast path's level-0 budget
    (61, 83, 2, 0, 1.0, "huber"),        # no valid pixel
    (61, 83, 2, 700, 1.0, None),
])
def test_photometric_kernel_matches_plain(cuda_device, h, w, stride, sparse, nan_depth,
                                          robust):
    """The count exactly, H, g and the energy within 1e-4 of each output's
    largest |entry| (f32 sums in another order), repeat calls bitwise equal,
    one launch counted per call."""
    args, kw = _photometric_case(cuda_device, h, w, stride, sparse, seed=h + sparse,
                                 nan_depth=nan_depth, robust=robust)
    n0 = photometric.photometric_hg.launches
    out = photometric.photometric_hg(*args, **kw)
    again = photometric.photometric_hg(*args, **kw)
    assert photometric.photometric_hg.launches == n0 + 2
    ref = photometric.photometric_hg_plain(*args, **kw)
    assert float(out[3]) == float(ref[3])
    if nan_depth == 1.0:
        assert float(ref[3]) == 0.0
    for a, b, c in zip(out, ref, again):
        assert torch.equal(a, c)
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1, 57, 64, 65, 192])
def test_stencil_kernels_match_plain(cuda_device, h):
    pts, valid = _points(cuda_device, h=h)
    cnt = stencil.neighbor_count(pts, valid, 0.05)
    assert torch.equal(cnt, stencil.neighbor_count_plain(pts, valid, 0.05))
    n, c = stencil.normals_stencil(pts, valid, 0.1)
    nr, cr = stencil.normals_stencil_plain(pts, valid, 0.1)
    assert torch.equal(c, cr)
    m = valid & (cr >= 6)
    if m.any():
        assert ((n * nr).sum(0)[m].abs() > 0.999).float().mean() >= 0.99


SIZES = [(240, 320), (480, 640), (120, 160), (61, 47), (7, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", SIZES)
def test_stencil_kernels_match_plain_at_frontend_sizes(cuda_device, h, w):
    """Counts exactly and normals by direction, on an ungated and a gated
    mask, at sizes that are and are not multiples of the tile."""
    depth, k = _depth(cuda_device, h, w, seed=h)
    pts0, _, gated = stencil.frontend_points_plain(depth, *k, 0.05, 16, 0.1, 0)
    for valid, radius in ((torch.isfinite(depth), 0.05), (gated, 0.1)):
        n0 = (stencil.neighbor_count.launches, stencil.normals_stencil.launches)
        cnt = stencil.neighbor_count(pts0, valid, radius)
        nrm, c = stencil.normals_stencil(pts0, valid, radius)
        assert (stencil.neighbor_count.launches, stencil.normals_stencil.launches) == \
            (n0[0] + 1, n0[1] + 1)
        nrm_p, c_p = stencil.normals_stencil_plain(pts0, valid, radius)
        assert torch.equal(cnt, c_p) and torch.equal(c, c_p)
        assert torch.isfinite(nrm).all()
        assert normal_agreement(nrm, nrm_p, valid & (c_p >= 6)) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("outlier_min_nb,normal_min_nb", [(16, 5), (0, 5), (16, 0), (0, 0)])
def test_frontend_kernel_matches_plain(cuda_device, h, w, outlier_min_nb, normal_min_nb):
    """Points bitwise, the final mask pixel for pixel, normals by direction
    on the mask and zero off it, repeat calls bitwise equal, one launch a
    call and none of the standalone kernels."""
    depth, k = _depth(cuda_device, h, w, seed=h + outlier_min_nb)
    gates = (0.05, outlier_min_nb, 0.1, normal_min_nb)
    n0 = (stencil.frontend_points.launches, stencil.neighbor_count.launches,
          stencil.normals_stencil.launches)
    out = stencil.frontend_points(depth, *k, *gates)
    again = stencil.frontend_points(depth, *k, *gates)
    assert (stencil.frontend_points.launches, stencil.neighbor_count.launches,
            stencil.normals_stencil.launches) == (n0[0] + 2, n0[1], n0[2])
    mism = frontend_mismatch(out, stencil.frontend_points_plain(depth, *k, *gates))
    assert frontend_ok(mism), mism
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if (h, w) == (240, 320):
        assert int(out[2].sum()) > 0.3 * h * w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_nan", "flat_wall"])
def test_frontend_kernel_degenerate_depths(cuda_device, case):
    depth = torch.full((48, 64), float("nan") if case == "all_nan" else 2.0,
                       device=cuda_device)
    k = (300.0, 300.0, 31.5, 23.5)
    out = stencil.frontend_points(depth, *k)
    mism = frontend_mismatch(out, stencil.frontend_points_plain(depth, *k))
    assert frontend_ok(mism), mism
    if case == "all_nan":
        assert not out[2].any() and torch.all(out[0] == 0) and torch.all(out[1] == 0)
    else:
        assert out[2][3:-3, 3:-3].all() and torch.all(out[1][2, 3:-3, 3:-3] < -0.999)


def _nan_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 4])
def test_row_gather_kernel_matches_plain(cuda_device, c):
    """Bit-exact, clip mode, NaN rows passed through; one launch counted."""
    g = torch.Generator().manual_seed(c)
    n, m = 5003, 20011
    rows = torch.randn((n,) if c == 1 else (n, c), generator=g)
    rows[torch.randint(0, n, (9,), generator=g)] = float("nan")
    idx = torch.randint(-100, n + 100, (m,), generator=g, dtype=torch.int32)
    rows, idx = rows.to(cuda_device), idx.to(cuda_device)
    before = dict(gather.row_gather.launches_by_c)
    out = gather.row_gather(rows, idx)
    assert gather.row_gather.launches_by_c == {**before, c: before[c] + 1}
    assert _nan_equal(out, gather.row_gather_plain(rows, idx))
    if c > 1:
        shifted = rows.reshape(-1)[1:1 + (n - 1) * c].view(n - 1, c)   # 4 bytes off
        with pytest.raises(ValueError, match="aligned"):
            gather.row_gather(shifted, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 257, 3200, 5120])
def test_lane_gather_kernel_matches_plain(cuda_device, b):
    """take_along_axis: a negative index wraps once, >= B or < -B is NaN."""
    g = torch.Generator().manual_seed(b)
    h = 37
    src = torch.randn(h, b, generator=g)
    idx = torch.randint(-b - 3, b + 3, (h, b), generator=g, dtype=torch.int32)
    src, idx = src.to(cuda_device), idx.to(cuda_device)
    n0 = gather.lane_gather.launches
    out = gather.lane_gather(src, idx)
    assert gather.lane_gather.launches == n0 + 1
    assert _nan_equal(out, gather.lane_gather_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("m,offset", [(5, 0), (24577, 0), (76803, 0), (307201, 0),
                                      (600003, 0), (24576, 1), (76800, 2), (307200, 3),
                                      (600002, 2), (1027, 1)])
def test_row_gather_kernel_ragged_edges(cuda_device, c, m, offset):
    """M not a multiple of the plan's R (R = 2 at 307201 and 600003 rows, the
    latter with a second round of the grid-stride loop), and an index vector
    ``offset`` indices into an aligned one (``idx[1:]``): bit-exact, NaN rows
    and out-of-range indices included, at the plan's R and block."""
    g = torch.Generator().manual_seed(m + offset + c)
    n = 307200
    rows = torch.randn((n,) if c == 1 else (n, c), generator=g)
    rows[torch.randint(0, n, (50,), generator=g)] = float("nan")
    full = torch.randint(-100, n + 100, (m + offset,), generator=g, dtype=torch.int32)
    rows, full = rows.to(cuda_device), full.to(cuda_device)
    idx = full[offset:]
    r = gather.row_plan(m, cuda_build.sm_count(cuda_device))[0]
    assert gather.row_vector_index(idx.data_ptr(), r) == (r > 1 and offset % r == 0)
    before = dict(gather.row_gather.launches_by_c)
    out = gather.row_gather(rows, idx)
    assert gather.row_gather.launches_by_c == {**before, c: before[c] + 1}
    assert _nan_equal(out, gather.row_gather_plain(rows, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("h,b,offset", [
    (37, 3201, 0),          # B % 4 != 0: rows staged by the block
    (300, 3200, 1),         # misaligned index vector: staged
    (5, gather.LANE_MAX, 0),                # the largest row, a 96 KB ring
    (700, gather.LANE_MAX, 0),
    (7, 3200, 0),           # fewer rows than the grid
    (480, 3200, 0), (2000, 1280, 0),        # more rows than the grid: the ring turns
])
def test_lane_gather_kernel_ring_and_staged_rows(cuda_device, h, b, offset):
    """The bulk-copy ring and the staged branch: bit-exact against the
    plain version, wrapped and out-of-range (NaN) indices included."""
    g = torch.Generator().manual_seed(h + b + offset)
    src = torch.randn(h, b, generator=g)
    src[torch.rand(h, b, generator=g) < 0.001] = float("nan")
    flat = torch.randint(-b - 3, b + 3, (h * b + offset,), generator=g, dtype=torch.int32)
    src, flat = src.to(cuda_device), flat.to(cuda_device)
    idx = flat[offset:].view(h, b)
    out = torch.empty_like(src)
    assert gather.lane_bulk(b, src.data_ptr(), idx.data_ptr(), out.data_ptr()) == \
        (b % 4 == 0 and offset == 0)
    n0 = gather.lane_gather.launches
    got = gather.lane_gather(src, idx)
    assert gather.lane_gather.launches == n0 + 1
    assert _nan_equal(got, gather.lane_gather_plain(src, idx))


@pytest.mark.cuda
def test_plain_references_launch_no_row_gather(cuda_device):
    """``photometric_hg_plain`` and ``select_gather_plain`` on the card
    gather in plain PyTorch: the row gather's counters do not move."""
    before = dict(gather.row_gather.launches_by_c)
    for sparse in (0, 1001):
        args, kw = _photometric_case(cuda_device, sparse=sparse)
        photometric.photometric_hg_plain(*args, **kw)
    g = torch.Generator().manual_seed(3)
    h, w = 61, 83
    planes = tuple(torch.randn(h, w, generator=g).to(cuda_device) for _ in range(4))
    vals, idx = torch.sort(torch.randn(h * w, generator=g).to(cuda_device),
                           descending=True, stable=True)
    gather.select_gather_plain(vals, idx, 1001, w, planes)
    torch.cuda.synchronize()
    assert gather.row_gather.launches_by_c == before


@pytest.mark.cuda
def test_selection_on_card_matches_cpu(cuda_device):
    """The sparse term's pixel selection on the card picks the pixels the
    CPU picks from the same planes (stable sort: ties lowest index first)."""
    g = torch.Generator().manual_seed(0)
    h, w = 240, 320
    inten = torch.rand(h, w, generator=g)
    depth = 1.0 + torch.rand(h, w, generator=g)
    depth[torch.rand(h, w, generator=g) < 0.1] = float("nan")
    grad = torch.where(torch.rand(2, h, w, generator=g) < 0.2,
                       torch.randn(2, h, w, generator=g), torch.zeros(2, h, w))
    cpu = imgproc.select_photometric_pixels(inten, depth, grad, 6144, 0.0, stride=2)
    card = imgproc.select_photometric_pixels(inten.to(cuda_device), depth.to(cuda_device),
                                             grad.to(cuda_device), 6144, 0.0, stride=2)
    for a, b in zip(cpu, card):
        assert _nan_equal(a, b.cpu()) if a.dtype.is_floating_point else torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_loop_on_card_matches_cpu(cuda_device):
    """The whole loop through the kernels (card) against the plain path
    (CPU) on the same frames: 320x240, 9 frames, the config's GN schedule.
    Tolerances as in test_torch_e2e.py (the GN early exit may pick a
    neighbouring iterate after an f32 rounding difference)."""
    import numpy as np

    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
    from nerf_fusion_tpu_torch.utils.config import dict_to_args, parse_config_yaml

    repo = CKPT.parent.parent.parent
    runs = {}
    for dev in ("cpu", cuda_device):
        args = parse_config_yaml(repo / "configs/fusion-synth.yaml")
        args.integrate_interval = args.meshing_interval = 3
        args.mapping = dict_to_args(args.mapping)
        args.mapping.latent_capacity, args.mapping.points_capacity = 4096, 8192
        args.tracking = dict_to_args(args.tracking)
        model, args.model = load_model(repo / args.training_hypers, 300)
        seq = SyntheticSequence(n_frames=9, width=320, height=240, device="cpu")
        pipe = FusionPipeline(model, args, dev)
        for i in range(9):
            f = seq.render_frame(i)
            f.rgb, f.depth = f.rgb.to(dev), f.depth.to(dev)
            pipe.process_frame(f, i)
        runs[str(dev)] = (pipe.trajectory(), pipe.mesher.extract(4, max_std=0.15))
    (tc, mc), (tg, mg) = runs["cpu"], runs[str(cuda_device)]
    for a, b in zip(tc, tg):
        assert np.linalg.norm(a.t - b.t) < 5e-3
    assert abs(len(mg) - len(mc)) <= 0.05 * len(mc) and len(mc) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["step", "first", "singular", "nan_energy", "worse",
                                  "last_step"])
def test_gn_step_kernel_matches_plain(cuda_device, kind):
    """The step on the card against its plain version (on the card too):
    the new pose within 1e-5 of its largest entry (f32 LU against
    cuSOLVER), the decisions and the reset of a finished group equal."""
    import numpy as np

    from nerf_fusion_tpu_torch.ops import gn

    rng = np.random.default_rng(len(kind))
    A = rng.normal(size=(6, 6))
    H = torch.tensor((A @ A.T + 0.5 * np.eye(6)) * 40.0, dtype=torch.float32)
    if kind == "singular":
        H = torch.ones(6, 6)
    g = torch.tensor(rng.normal(size=6) * 0.5, dtype=torch.float32)
    energy = {"nan_energy": float("nan"), "worse": 2.0}.get(kind, 0.5)
    state = gn.new_state(3, "cpu")
    xi = torch.tensor(rng.normal(size=6) * 0.01, dtype=torch.float32)
    R, t = st.se3_exp(xi)
    state.pose[0:12] = torch.cat([R.reshape(-1), t])
    state.pose[12:24] = torch.cat([R.reshape(-1), t])
    if kind != "first":
        state.pose[24] = 1.0
        state.ints[0] = 4 if kind == "last_step" else 2
    a = gn.GNState(*(x.to(cuda_device) for x in state))
    b = gn.GNState(*(x.clone().to(cuda_device) for x in state))
    args = (H.to(cuda_device), g.to(cuda_device), torch.tensor(energy, device=cuda_device))
    n0 = gn.gn_step.launches
    gn.gn_step(*args, a, 1, 4)
    assert gn.gn_step.launches == n0 + 1
    gn.gn_step_plain(*args, b, 1, 4)
    scale = max(float(b.pose[:24].abs().max()), 1.0)
    assert float((a.pose[:24] - b.pose[:24]).abs().max()) <= 1e-5 * scale
    for x, y in zip((a.ints, a.done, a.iters, a.pose[24:]), (b.ints, b.done, b.iters,
                                                             b.pose[24:])):
        assert torch.equal(x, y)
    assert bool(a.done) == (kind in ("nan_energy", "worse"))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,k", [(480, 640, 24576), (240, 320, 19200), (61, 83, 1001)])
def test_select_gather_kernel_matches_plain(cuda_device, h, w, k):
    """Bitwise, NaN positions included; one launch counted."""
    g = torch.Generator().manual_seed(h)
    planes = [torch.rand(h, w, generator=g), 1.0 + torch.rand(h, w, generator=g),
              torch.randn(h, w, generator=g), torch.randn(h, w, generator=g)]
    planes[1][torch.rand(h, w, generator=g) < 0.1] = float("nan")
    score = torch.where(torch.rand(h * w, generator=g) < 0.6, torch.rand(h * w, generator=g),
                        torch.full((h * w,), -1.0))
    vals, idx = torch.sort(score.to(cuda_device), descending=True, stable=True)
    planes = tuple(p.to(cuda_device) for p in planes)
    n0 = gather.select_gather.launches
    out = gather.select_gather(vals, idx, k, w, planes)
    assert gather.select_gather.launches == n0 + 1
    ref = gather.select_gather_plain(vals, idx, k, w, planes)
    for a, b in zip(out, ref):
        assert a.is_contiguous() and a.shape == (k,)
        assert _nan_equal(a.float(), b.float())


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 6144])
def test_tracked_frames_replay_as_graphs(cuda_device, budget):
    """A 320x240 run on the card: every tracked frame after the first is
    graph replays, one evaluation through a captured graph gives H, g and
    energy bitwise equal to the eager call, and the launch counters hold
    what ran (a replay adds its graph's kernels)."""
    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.ops import gn, launches
    from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
    from nerf_fusion_tpu_torch.tools import graph_check
    from nerf_fusion_tpu_torch.utils.config import dict_to_args, parse_config_yaml

    repo = CKPT.parent.parent.parent
    args = parse_config_yaml(repo / "configs/fusion-synth.yaml")
    args.mapping = dict_to_args(args.mapping)
    args.tracking = dict_to_args(args.tracking)
    args.tracking.rgb["pixel_budget"] = budget
    model, args.model = load_model(repo / args.training_hypers, 300)
    seq = SyntheticSequence(n_frames=8, width=320, height=240, device=cuda_device)
    pipe = FusionPipeline(model, args, cuda_device)
    for i in range(3):
        pipe.process_frame(seq.render_frame(i), i)
    tr = pipe.tracker
    before, replays = launches.snapshot(), tr.graph_replays
    for i in range(3, 8):
        pipe.process_frame(seq.render_frame(i), i)
    torch.cuda.synchronize()
    ran = launches.diff(launches.snapshot(), before)
    evals = tr.graph_replays - replays - 2 * 5
    assert evals >= 15 and ran["gn_step"] == evals
    assert ran["photometric_hg"] >= evals and ran["stencil_frontend"] == 5
    assert (ran["select_gather"] > 0) == (budget > 0)
    for group in range(3):
        got, ref = graph_check.graph_vs_eager(tr, group)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.isfinite(p).all() for p in tr.all_pd_pose[-1])
    assert isinstance(tr.gn, gn.GNState)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,stride,sparse,robust", [
    (480, 640, 2, 0, "huber"),           # the loop's level 0, dense
    (240, 320, 2, 0, None),
    (480, 640, 2, 24576, None),          # the fast path's level-0 budget
    (61, 83, 1, 1001, "tukey"),
])
def test_photometric_kernel_forms_the_warp(cuda_device, h, w, stride, sparse, robust):
    """Given dR, dt and the level's (K, K^-1), the kernel forms K dR K^-1
    and K dt as the plain version's cuBLAS products round them: the valid
    count exactly the plain version's (on the card), H, g and the energy
    within 1e-4 of each output's largest |entry|, and the same outputs as
    the kernel given the products formed beforehand."""
    args, kw = _photometric_case(cuda_device, h, w, stride, sparse, seed=h + sparse + 1,
                                 nan_depth=0.05, robust=robust)
    rows, level, _, _, fx, fy, cx, cy = args
    R, t = st.se3_exp(torch.tensor([0.03, -0.02, 0.02, 0.01, 0.04, -0.005]))
    K, Kinv = _intrinsics(fx, fy, cx, cy, cuda_device)
    R, t = R.contiguous().to(cuda_device), t.to(cuda_device)
    pose = (rows, level, R, t, fx, fy, cx, cy)
    out = photometric.photometric_hg(*pose, K=(K, Kinv), **kw)
    ref = photometric.photometric_hg_plain(*pose, K=(K, Kinv), **kw)
    formed = photometric.photometric_hg(rows, level, K @ R @ Kinv, K @ t, fx, fy, cx, cy,
                                        **kw)
    assert float(out[3]) == float(ref[3]) > 0
    for a, b, c in zip(out, ref, formed):
        assert torch.equal(a, c)
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


def _room_sdf_case(device, model, n=8192):
    """The room's map after frame 10 integrated at its pose, frame 11's
    first ``n`` points and its true delta pose: sdf_rows' operands."""
    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.system.map import SparseVoxelMap
    from nerf_fusion_tpu_torch.system.tracker import SDFTracker
    from nerf_fusion_tpu_torch.utils.config import dict_to_args, parse_config_yaml

    args = parse_config_yaml(CKPT.parent.parent.parent / "configs/fusion-synth.yaml")
    model.to(device)
    seq = SyntheticSequence(n_frames=20, width=640, height=480, device=device)
    f0, f1 = seq.render_frame(10), seq.render_frame(11)
    c = f0.calib
    vmap = SparseVoxelMap(model, dict_to_args(args.mapping), 29, device)
    tracker = SDFTracker(vmap, args.tracking, point_budget=40960)
    pre0 = tracker.preprocess(f0.rgb, f0.depth, c)
    pre1 = tracker.preprocess(f1.rgb, f1.depth, c)
    R0 = torch.as_tensor(f0.gt_pose.q.rotation_matrix, dtype=torch.float32, device=device)
    t0 = torch.as_tensor(f0.gt_pose.t, dtype=torch.float32, device=device)
    vmap.integrate_keyframe(pre0.points, pre0.normals, pre0.mask, pose=(R0, t0))
    rel = f0.gt_pose.inv().dot(f1.gt_pose).matrix
    dR = torch.as_tensor(rel[:3, :3], dtype=torch.float32, device=device).contiguous()
    dt = torch.as_tensor(rel[:3, 3], dtype=torch.float32, device=device).contiguous()
    cfg, st_ = vmap.cfg, vmap.state
    return (pre1.points[:n], pre1.mask[:n], dR, dt, R0.contiguous(), t0, vmap.bound_min,
            cfg.voxel_size, cfg.n_xyz, st_.indexer, st_.obs_count, st_.latents,
            cfg.ignore_count_th)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,k", [("huber", 5.0), ("tukey", 3.0), (None, 1.0)])
def test_sdf_kernels_match_plain(cuda_device, model, kernel, k):
    """At the GN budget of 8192 rows on the room's map: sdf_rows' decoder
    input, p_delta and use bitwise the plain version's (the voxel of every
    point decided alike); sdf_hg's count exactly, H, g and the energy within
    1e-5 of each output's largest |entry|; one launch counted a call."""
    args = _room_sdf_case(cuda_device, model)
    dec = model.decoder
    n0 = (sdf_term.sdf_rows.launches, sdf_term.sdf_hg.launches)
    rows = sdf_term.sdf_rows(*args)
    plain = sdf_term.sdf_rows_plain(*args)
    torch.cuda.synchronize()
    print(f"sdf_rows: {int((rows[0] != plain[0]).any(1).sum())} rows of x, "
          f"{int((rows[1] != plain[1]).any(1).sum())} of p_delta, "
          f"{int((rows[2] != plain[2]).sum())} use bits differ; "
          f"{int(rows[2].sum())} rows used of {rows[2].shape[0]}")
    for a, b in zip(rows, plain):
        assert torch.equal(a, b)
    assert int(rows[2].sum()) > 1000
    out, grad = mlp.decoder_forward_grad(rows[0], dec.packed, dec.mats)
    vs, last_R = args[7], args[4]
    res = sdf_term.sdf_hg(out, grad, rows[1], rows[2], last_R, vs, kernel, k)
    ref = sdf_term.sdf_hg_plain(out, grad, rows[1], rows[2], last_R, vs, kernel, k)
    assert (sdf_term.sdf_rows.launches, sdf_term.sdf_hg.launches) == (n0[0] + 1, n0[1] + 1)
    assert float(res[43]) == float(ref[43]) == float(rows[2].sum())
    for lo, hi in ((0, 36), (36, 42), (42, 43)):
        a, b = res[lo:hi], ref[lo:hi]
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), (lo, a, b)
    assert float(res[42]) > 0


@pytest.mark.cuda
def test_sdf_term_deterministic_across_replays(cuda_device, model):
    """sdf_rows, decoder_forward_grad and sdf_hg captured in one CUDA graph:
    20 replays give the same H, g, energy and count bit for bit."""
    args = _room_sdf_case(cuda_device, model)
    dec = model.decoder

    def term():
        x, p_delta, use = sdf_term.sdf_rows(*args)
        out, grad = mlp.decoder_forward_grad(x, dec.packed, dec.mats)
        return sdf_term.sdf_hg(out, grad, p_delta, use, args[4], args[7], "huber", 5.0)

    eager = term()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = term()
    got = []
    for _ in range(20):
        graph.replay()
        got.append(res.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(got[0], r) for r in got) and torch.equal(got[0], eager)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 6144])
def test_evaluation_graphs_are_hand_written_kernels(cuda_device, budget):
    """fusion-synth's 10 / 10 / 50 schedule at 320x240: the evaluation graphs
    of the rgb-only group and of the two SDF-plus-rgb groups hold 2, 5 and 5
    kernel nodes, each one of the port's launches (no PyTorch kernel runs
    between two GN steps), ``stats.json``'s counter records them, and over
    three traced frames the launch counters equal the profiler's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.ops import launches
    from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
    from nerf_fusion_tpu_torch.utils import trace
    from nerf_fusion_tpu_torch.utils.config import dict_to_args, parse_config_yaml

    repo = CKPT.parent.parent.parent
    args = parse_config_yaml(repo / "configs/fusion-synth.yaml")
    args.mapping = dict_to_args(args.mapping)
    args.tracking = dict_to_args(args.tracking)
    args.tracking.rgb["pixel_budget"] = budget
    model, args.model = load_model(repo / args.training_hypers, 300)
    seq = SyntheticSequence(n_frames=8, width=320, height=240, device=cuda_device)
    pipe = FusionPipeline(model, args, cuda_device)
    with trace.capture() as cap:
        for i in range(3):
            pipe.process_frame(seq.render_frame(i), i)
    graphs = pipe.tracker._step.graphs["iteration"]
    assert [g.nodes for g in graphs] == [2, 5, 5]
    assert all(g.nodes == sum(g.launches.values()) for g in graphs)
    assert graphs[2].launches == dict(dict.fromkeys(launches.NAMES, 0), sdf_rows=1,
                                      decoder_forward_grad=1, sdf_hg=1, photometric_hg=1,
                                      gn_step=1)
    counters = cap.export()["counters"]
    assert [counters[f"tracker.graph_nodes.g{g}"] for g in range(3)] == [2, 5, 5]
    frames = [seq.render_frame(i) for i in range(3, 6)]
    torch.cuda.synchronize()
    before = launches.snapshot()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, f in enumerate(frames, 3):
            pipe.process_frame(f, i)
        torch.cuda.synchronize()
    ran = launches.diff(launches.snapshot(), before)
    traced = dict.fromkeys(launches.NAMES, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.name().startswith(("Memcpy",
                                                                           "Memset")):
            name = launches.counter_of(e.name())
            if name is not None:
                traced[name] += 1
    assert traced == ran and ran["sdf_rows"] == ran["sdf_hg"] > 0


def _full_width_train_args():
    from nerf_fusion_tpu_torch.utils.config import parse_config_yaml

    args = parse_config_yaml(CKPT.parent.parent.parent / "configs/train-cnp.yaml")
    # no dropout: the card's and the CPU's random streams differ
    args.network_specs = dict(args.network_specs, dropout_prob=0.0)
    return args


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One step of configs/train-cnp.yaml at its full width (latent 29,
    decoder 128 x 4 with weight norm, encoder 6-32-64-256 with BatchNorm,
    16 LIFs x 4096 samples + 128 surface points, dropout off): the loss
    terms and every gradient on the card within 1e-4 of the CPU's."""
    from nerf_fusion_tpu_torch.models.io import build_model
    from nerf_fusion_tpu_torch.trainer.train import TrainStep
    from nerf_fusion_tpu_torch.utils.config import dict_to_args

    args = _full_width_train_args()
    g = torch.Generator().manual_seed(0)
    sdf = torch.cat([torch.rand(16, 4096, 3, generator=g) - 0.5,
                     0.2 * torch.randn(16, 4096, 1, generator=g)], -1)
    nrm = torch.randn(16, 128, 3, generator=g)
    surf = torch.cat([torch.rand(16, 128, 3, generator=g) - 0.5,
                      nrm / nrm.norm(dim=-1, keepdim=True)], -1)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        model = build_model(args, seed=0).to(dev)
        step = TrainStep(model, dict_to_args(args.training_loss), 4096, 1,
                         torch.Generator(device=dev).manual_seed(0))
        logs = step.loss_and_grads(sdf.to(dev), surf.to(dev), 1)
        grads = {f"dec.{n}": p.grad.cpu() for n, p in model.decoder.named_parameters()}
        grads.update({f"enc.{n}": p.grad.cpu() for n, p in model.encoder.named_parameters()})
        out[dev.type] = ({k: v.item() for k, v in logs.items()}, grads)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]), k
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-4 * gc[k].abs().max(), k


@pytest.mark.cuda
def test_trained_checkpoint_through_the_kernels(cuda_device):
    """ckpt/full_trained (600 epochs) loaded into the training modules and
    folded by load_model: decoder_forward on 262144 rows and
    encoder_forward on 327680 rows within 1e-4 of the training modules in
    eval mode."""
    from nerf_fusion_tpu_torch.models import io
    from nerf_fusion_tpu_torch.models.encoder import EncoderConfig, TrainEncoder
    from nerf_fusion_tpu_torch.utils.config import parse_config_json

    hyper = CKPT.parent.parent / "full_trained/hyper.json"
    args = parse_config_json(hyper)
    nets, _ = load_model(hyper, 600)
    nets.to(cuda_device)
    tdec = io.load_checkpoint(io.build_model(args), hyper.parent, 600).decoder
    tdec.to(cuda_device).eval()
    enc = io.load_params(hyper.parent / "encoder_600.npz")
    tenc = TrainEncoder(EncoderConfig(args.code_length, args.encoder_specs["per_point_feat"],
                                      bn=args.encoder_specs.get("bn"), mode="cnp"),
                        enc["params"], enc["bn"]).to(cuda_device).eval()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.cat([0.3 * torch.randn(262144, 29, device=cuda_device, generator=g),
                   torch.rand(262144, 3, device=cuda_device, generator=g) - 0.5], 1)
    pts = torch.randn(327680, 6, device=cuda_device, generator=g)
    with torch.no_grad():
        sdf_k, std_k = nets.decoder(x)
        sdf_t, std_t = tdec(x)
        lat_k, lat_t = nets.encoder(pts), tenc(pts)
    assert (sdf_k - sdf_t).abs().max() <= 1e-4 and (std_k - std_t).abs().max() <= 1e-4
    assert (lat_k - lat_t).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["room", "large"])
def test_batch_render_on_card_matches_single_frame_render(cuda_device, scene):
    """On the card an iterated synthetic sequence renders ``RENDER_BATCH``
    frames in one pass: each frame bitwise the single-frame render of its
    pose (NaN depth at the same pixels), a short last batch included."""
    from nerf_fusion_tpu_torch.data import synth

    n = synth.RENDER_BATCH + 3
    seq = synth.SyntheticSequence(n_frames=n, width=160, height=120, scene=scene,
                                  device=cuda_device)
    for i, f in enumerate(seq):
        want = seq.render_frame(i)
        for a, b in ((f.rgb, want.rgb), (f.depth, want.depth)):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert i == n - 1
