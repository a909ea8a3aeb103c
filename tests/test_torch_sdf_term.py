"""The GN evaluation as hand-written kernels, on the CPU: the SDF term's two
kernels' plain versions (``ops/sdf_term.py``), the summing GN step and the
photometric term that forms K dR K^-1 and K dt itself, each held bitwise
against the PyTorch composition the tracker ran before them."""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import gn, imgproc, launches, mlp, photometric, sdf_term
from nerf_fusion_tpu_torch.system import tracker as TT
from nerf_fusion_tpu_torch.system.frontend import Pyramid
from nerf_fusion_tpu_torch.system.map import MapConfig, MapState, get_sdf
from nerf_fusion_tpu_torch.utils import se3_torch as st

CKPT = Path(__file__).resolve().parent.parent / "ckpt/default/hyper.json"
KERNELS = [("huber", 5.0), ("tukey", 3.0), (None, 1.0)]


@pytest.fixture(scope="module")
def decoder():
    model, _ = load_model(CKPT, 300)
    return model.decoder


def _tcfg(kernel, k):
    return TT.TrackerConfig(iter_config=((10, (("sdf",),)),), sdf_robust_kernel=kernel,
                            sdf_robust_k=k, subsample=0.5, rgb_robust_kernel=None,
                            rgb_robust_k=0.01, min_grad_scale=0.0, max_depth_delta=0.2,
                            motion_weight=1.0, rgb_stride=1, scale_level_intrinsics=False)


def _map(seed=0):
    """A 6 x 5 x 7 map: 150 of its 210 voxels hold a slot, a third of those
    under the count gate."""
    g = torch.Generator().manual_seed(seed)
    cfg = MapConfig(n_xyz=(6, 5, 7), voxel_size=0.1, bound_min=(-0.3, -0.25, 0.2),
                    prune_min_vox_obs=1, ignore_count_th=5.0, encoder_count_th=20.0,
                    latent_dim=29, latent_capacity=160, alloc_capacity=160)
    n_vox = 6 * 5 * 7
    indexer = torch.full((n_vox,), -1, dtype=torch.int32)
    held = torch.randperm(n_vox, generator=g)[:150]
    indexer[held] = torch.randperm(150, generator=g).to(torch.int32)
    obs = torch.where(torch.rand(160, generator=g) < 0.33, torch.full((160,), 2.0),
                      5.0 + 10.0 * torch.rand(160, generator=g))
    state = MapState(indexer=indexer, latents=0.3 * torch.randn(160, 29, generator=g),
                     positions=torch.full((160,), -1, dtype=torch.int32), obs_count=obs,
                     optimized=torch.zeros(160, dtype=torch.bool),
                     n_occupied=torch.tensor(150, dtype=torch.int32),
                     overflow=torch.tensor(False))
    return cfg, state


def _frame(cfg, seed=0, n=3000, all_masked=False):
    """Points in the last camera's frame whose world points fill the map's box
    and a margin around it, the last pose (not the identity), a delta pose
    and the mask."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor(cfg.bound_min)
    ext = torch.tensor(cfg.n_xyz, dtype=torch.float32) * cfg.voxel_size
    world = lo + (1.3 * torch.rand(n, 3, generator=g) - 0.15) * ext
    last_R, last_t = st.se3_exp(torch.tensor([0.1, -0.2, 0.3, 0.2, -0.1, 0.3]))
    dR, dt = st.se3_exp(torch.tensor([0.004, -0.003, 0.002, 0.01, 0.006, -0.008]))
    pts = ((world - last_t) @ last_R).contiguous()
    mask = torch.zeros(n, dtype=torch.bool) if all_masked \
        else torch.rand(n, generator=g) < 0.85
    return pts, mask, last_R.contiguous(), last_t, dR.contiguous(), dt


def _sdf_Hg_composed(state, cfg, decoder, tcfg, last_R, last_t, dR, dt, pts, mask,
                     bound_min):
    """The SDF term as the tracker composed it before its kernels: the point
    transforms, ``get_sdf`` and the reductions as matrix products."""
    p_delta = st.transform_points(dR, dt, pts)
    p_world = st.transform_points(last_R, last_t, p_delta)
    sdf, std, valid, dsdf_drel = get_sdf(state, cfg, decoder, p_world, bound_min,
                                         with_grad=True)
    r = sdf / std
    dsdf_dpos = (torch.ones_like(std) / std)[:, None] * dsdf_drel / cfg.voxel_size
    m = (mask & valid).to(r.dtype)
    La = last_R.T @ dsdf_dpos.T
    q = p_delta.T
    Lb = torch.stack([q[1] * La[2] - q[2] * La[1],
                      q[2] * La[0] - q[0] * La[2],
                      q[0] * La[1] - q[1] * La[0]], 0)
    J = torch.cat([La, Lb], dim=0)
    w = photometric.robust_weight(r, tcfg.sdf_robust_kernel, tcfg.sdf_robust_k) * m
    scale = 1.0 / torch.clamp_min(m.sum(), 1.0)
    H = ((J * w[None, :]) @ J.T) * scale
    g = (J @ (w * r)) * scale
    energy = torch.sum(r * (w * r)) * scale
    return H, g, energy


@pytest.mark.parametrize("kernel,k", KERNELS)
@pytest.mark.parametrize("all_masked", [False, True])
def test_sdf_chain_is_the_old_composition(decoder, kernel, k, all_masked):
    cfg, state = _map()
    pts, mask, last_R, last_t, dR, dt = _frame(cfg, all_masked=all_masked)
    bmin = torch.tensor(cfg.bound_min)
    x, p_delta, use = sdf_term.sdf_rows_plain(
        pts, mask, dR, dt, last_R, last_t, bmin, cfg.voxel_size, cfg.n_xyz, state.indexer,
        state.obs_count, state.latents, cfg.ignore_count_th)
    out, grad = mlp.decoder_forward_grad_plain(x, decoder.mats)
    res = sdf_term.sdf_hg_plain(out, grad, p_delta, use, last_R, cfg.voxel_size, kernel, k)
    tcfg = _tcfg(kernel, k)
    ref = _sdf_Hg_composed(state, cfg, decoder, tcfg, last_R, last_t, dR, dt, pts, mask,
                           bmin)
    got = (res[:36].view(6, 6), res[36:42], res[42])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # the tracker's term takes the same path through the wrappers
    term = TT._sdf_Hg(state, cfg, decoder, tcfg, last_R, last_t, dR, dt, pts, mask, bmin)
    assert all(torch.equal(a, b) for a, b in zip(term, ref))
    # the cases the kernel must decide as the composition does
    world = st.transform_points(last_R, last_t, st.transform_points(dR, dt, pts))
    grid = torch.ceil((world - bmin) / cfg.voxel_size).long() - 1
    inb = ((grid >= 0) & (grid < torch.tensor(cfg.n_xyz))).all(1)
    gid = (grid.clamp_min(0).minimum(torch.tensor(cfg.n_xyz) - 1)
           * torch.tensor([35, 7, 1])).sum(1)
    slot = state.indexer.long()[gid]
    gated = inb & (slot >= 0) & (state.obs_count[slot.clamp_min(0)] <= cfg.ignore_count_th)
    assert int((~inb).sum()) > 100 and int(gated.sum()) > 100 and int((inb & (slot < 0)).sum())
    if all_masked:
        assert float(res[43]) == 0.0 and not use.any()
        assert torch.equal(got[0], torch.zeros(6, 6)) and float(got[2]) == 0.0
    else:
        assert float(res[43]) == float(use.sum()) > 500
        assert float(got[2]) > 0


def test_sdf_rows_latent_rows_and_rel(decoder):
    """x holds each point's clamped slot's latent and its voxel-local
    coordinates in [-0.5, 0.5] where the point is used; on the CPU the
    wrappers count no launch."""
    cfg, state = _map(1)
    pts, mask, last_R, last_t, dR, dt = _frame(cfg, seed=1)
    bmin = torch.tensor(cfg.bound_min)
    n0 = (sdf_term.sdf_rows.launches, sdf_term.sdf_hg.launches)
    x, p_delta, use = sdf_term.sdf_rows(
        pts, mask, dR, dt, last_R, last_t, bmin, cfg.voxel_size, cfg.n_xyz, state.indexer,
        state.obs_count, state.latents, cfg.ignore_count_th)
    out, grad = mlp.decoder_forward_grad_plain(x, decoder.mats)
    sdf_term.sdf_hg(out, grad, p_delta, use, last_R, cfg.voxel_size, "huber", 5.0)
    assert x.shape == (pts.shape[0], 32) and use.dtype == torch.bool
    assert torch.equal(p_delta, st.transform_points(dR, dt, pts))
    rel = x[use, 29:]
    assert float(rel.abs().max()) <= 0.5
    assert bool((x[:, None, :29] == state.latents[None]).all(-1).any(1).all())
    # the CPU takes the plain versions
    assert (sdf_term.sdf_rows.launches, sdf_term.sdf_hg.launches) == n0


def test_sdf_wrappers_check_their_operands(decoder):
    cfg, state = _map()
    pts, mask, last_R, last_t, dR, dt = _frame(cfg)
    bmin = torch.tensor(cfg.bound_min)
    args = [pts, mask, dR, dt, last_R, last_t, bmin, cfg.voxel_size, cfg.n_xyz,
            state.indexer, state.obs_count, state.latents, cfg.ignore_count_th]
    for i, bad in ((0, pts[:, :2]), (1, mask.float()), (2, dR.double()),
                   (9, state.indexer.long()), (11, state.latents[:, :28])):
        with pytest.raises(ValueError):
            sdf_term.sdf_rows(*args[:i], bad, *args[i + 1:])
    x, p_delta, use = sdf_term.sdf_rows(*args)
    out, grad = mlp.decoder_forward_grad_plain(x, decoder.mats)
    with pytest.raises(ValueError):
        sdf_term.sdf_hg(out, grad[:-1], p_delta, use, last_R, 0.1, "huber", 5.0)
    with pytest.raises(NotImplementedError):
        sdf_term.sdf_hg(out, grad, p_delta, use, last_R, 0.1, "cauchy", 5.0)


def _terms(n_terms, seed):
    g = torch.Generator().manual_seed(seed)
    parts = []
    for _ in range(n_terms):
        A = torch.randn(6, 6, generator=g)
        parts.append((A @ A.T + 0.5 * torch.eye(6), 0.5 * torch.randn(6, generator=g),
                      torch.rand((), generator=g)))
    return tuple(zip(*parts))


@pytest.mark.parametrize("n_terms", [1, 2, 3])
@pytest.mark.parametrize("kind", ["step", "worse", "last_step"])
def test_summing_step_is_build_Hg_then_the_step(n_terms, kind):
    """``gn_step`` given the terms apart sums them as ``build_Hg`` did
    (zeros, then each term added) and steps as on the sums."""
    Hs, gs, es = _terms(n_terms, seed=n_terms)
    H, g, energy = torch.zeros(6, 6), torch.zeros(6), torch.zeros(())
    for Ht, gt, et in zip(Hs, gs, es):
        H, g, energy = H + Ht, g + gt, energy + et
    state = gn.new_state(3, "cpu")
    R, t = st.se3_exp(torch.tensor([0.01, -0.02, 0.005, 0.02, 0.01, -0.01]))
    state.pose[0:12] = torch.cat([R.reshape(-1), t])
    state.pose[12:24] = torch.cat([R.reshape(-1), t])
    state.pose[24] = -1.0 if kind == "worse" else 10.0
    state.ints[0] = 4 if kind == "last_step" else 2
    a = gn.GNState(*(x.clone() for x in state))
    b = gn.GNState(*(x.clone() for x in state))
    c = gn.GNState(*(x.clone() for x in state))
    n0 = gn.gn_step.launches
    got = gn.gn_step_plain(Hs, gs, es, a, 1, 4)
    gn.gn_step_plain(H, g, energy, b, 1, 4)
    wrapped = gn.gn_step(Hs, gs, es, c, 1, 4)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    for x, y, z in zip(got, (H, g, energy), wrapped):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert bool(a.done) == (kind == "worse")
    assert gn.gn_step.launches == n0


def test_gn_step_takes_at_most_max_terms():
    Hs, gs, es = _terms(gn.MAX_TERMS + 1, seed=0)
    with pytest.raises(ValueError):
        gn.gn_step(Hs, gs, es, gn.new_state(1, "cpu"), 0, 4)
    with pytest.raises(ValueError):
        gn.gn_step(Hs[:2], gs[:1], es[:2], gn.new_state(1, "cpu"), 0, 4)


def _level(seed, h=24, w=32):
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    inten = 0.5 + 0.3 * torch.sin(xx / 3.0) * torch.cos(yy / 4.0) \
        + 0.01 * torch.rand(h, w, generator=g)
    depth = 1.5 + 0.2 * torch.sin(xx / 7.0) + 0.01 * torch.rand(h, w, generator=g)
    depth[torch.rand(h, w, generator=g) < 0.05] = float("nan")
    grad = torch.stack([torch.roll(inten, -1, 1) - inten, torch.roll(inten, -1, 0) - inten])
    prev = imgproc.intensity_depth_rows(torch.roll(inten, 1, 1), depth)
    return prev, photometric.Dense(inten, depth, grad.contiguous())


@pytest.mark.parametrize("kernel,k", [("huber", 0.05), ("tukey", 0.1), (None, 0.01)])
@pytest.mark.parametrize("sparse", [False, True])
def test_photometric_forms_the_warp_as_the_tracker_did(kernel, k, sparse):
    """``photometric_hg(_plain)`` given dR, dt and the level's (K, K^-1)
    equals the call given K dR K^-1 and K dt formed beforehand, as
    ``_rgb_Hg`` formed them."""
    prev, level = _level(3)
    h, w = level.intensity.shape
    fx, fy, cx, cy = 30.0, 31.5, (w - 1) / 2.0, (h - 1) / 2.0
    if sparse:
        level = photometric.Sparse(w, h, imgproc.select_photometric_pixels(
            *level, 300, 0.0, stride=1))
    K, Kinv = TT._intrinsics(fx, fy, cx, cy, "cpu")
    dR, dt = st.se3_exp(torch.tensor([0.01, -0.005, 0.02, 0.003, -0.004, 0.002]))
    dR = dR.contiguous()
    kw = dict(min_grad_scale=0.0, max_depth_delta=0.2, stride=1, robust_kernel=kernel,
              robust_k=k, rgb_weight=500.0)
    old = photometric.photometric_hg_plain(prev, level, K @ dR @ Kinv, K @ dt, fx, fy, cx,
                                           cy, **kw)
    new = photometric.photometric_hg_plain(prev, level, dR, dt, fx, fy, cx, cy, K=(K, Kinv),
                                           **kw)
    wrapped = photometric.photometric_hg(prev, level, dR, dt, fx, fy, cx, cy, K=(K, Kinv),
                                         **kw)
    assert float(old[3]) > 100
    for a, b, c in zip(old, new, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_new_kernels_have_counters():
    assert {"sdf_rows", "sdf_hg"} <= set(launches.NAMES)
    assert launches.counter_of("void (anonymous namespace)::sdf_rows_kernel("
                               "(anonymous namespace)::RowsArgs)") == "sdf_rows"
    assert launches.counter_of("void (anonymous namespace)::sdf_hg_kernel("
                               "(anonymous namespace)::HgArgs)") == "sdf_hg"
    before = launches.snapshot()
    launches.add({"sdf_rows": 2, "sdf_hg": 3})
    assert launches.diff(launches.snapshot(), before) == dict(
        dict.fromkeys(launches.NAMES, 0), sdf_rows=2, sdf_hg=3)
    launches.add({"sdf_rows": 2, "sdf_hg": 3}, -1)


def test_tracker_evaluation_on_cpu_matches_build_Hg():
    """One evaluation of a two-term group through ``gn_iteration`` (the
    summing step) against ``build_Hg`` and the step on the sums."""
    cfg, state = _map(2)
    model, _ = load_model(CKPT, 300)
    pts, mask, last_R, last_t, dR, dt = _frame(cfg, seed=2)
    prev, level = _level(4)
    h, w = level.intensity.shape
    fx, fy, cx, cy = 30.0, 31.5, (w - 1) / 2.0, (h - 1) / 2.0
    tcfg = _tcfg("huber", 5.0)._replace(iter_config=((3, (("sdf",), ("rgb", 0))),))
    pyr = Pyramid((level.intensity,), (level.depth,), (level.gradient,))
    f = TT._Terms(state, cfg, model.decoder, torch.tensor(cfg.bound_min), tcfg, last_R,
                  last_t, pts, mask, pyr, {0: prev}, {},
                  {0: TT._intrinsics(fx, fy, cx, cy, "cpu")}, fx, fy, cx, cy, 500.0)
    a, b = gn.new_state(1, "cpu"), gn.new_state(1, "cpu")
    for s in (a, b):
        s.pose[0:12] = torch.cat([dR.reshape(-1), dt])
    got = TT.gn_iteration(f, a, 0)
    ref = TT.build_Hg(f, tcfg.iter_config[0][1], b.dR, b.dt)
    gn.gn_step_plain(*ref, b, 0, 3)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert np.isfinite(float(got[2])) and float(got[2]) > 0
