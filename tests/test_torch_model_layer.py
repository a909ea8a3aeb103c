"""The port's model layer against the JAX package's: ``models/apply.py``,
``models/zoo.py``, ``utils/rays.py`` and ``models/img_encoder.py``.

Inputs are made from numpy seeds and handed to both packages; the weights
go across with ``models.io.mlp_from_jax`` / ``img_encoder_from_jax``.
Tolerances: 1e-5 absolute for the apply helpers and the rays (f32, order
of summation only), 1e-6 relative for the zoo's MLPs, and 1e-5 of the
largest output entry for the image encoders (f32 convolutions and group
norms, summed in another order by XLA and by PyTorch's CPU kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_fusion_tpu.models import apply as japply
from nerf_fusion_tpu.models import img_encoder as jie
from nerf_fusion_tpu.models import zoo as jzoo
from nerf_fusion_tpu.utils import rays as jrays
from nerf_fusion_tpu_torch.models import apply, img_encoder as ie, zoo
from nerf_fusion_tpu_torch.models.io import img_encoder_from_jax, mlp_from_jax
from nerf_fusion_tpu_torch.utils import rays

TOL_ENC = 1e-5      # of the output's largest |entry|


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(out, ref, tol=TOL_ENC):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= tol, err


# -- apply ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tuple", "dict"])
def test_chunked_apply_equals_one_call(kind):
    x = torch.as_tensor(np.random.RandomState(0).randn(1031, 5).astype(np.float32))
    if kind == "tuple":
        fn = lambda t: (t * 2, t.sum(1))
    else:
        fn = lambda t: {"a": t * 2, "b": t.sum(1)}
    whole, parts = fn(x), apply.chunked_apply(fn, x, max_chunk=100)
    keys = range(2) if kind == "tuple" else ("a", "b")
    for k in keys:
        assert torch.equal(whole[k], parts[k])
    # and against the JAX helper on the same rows
    jout = japply.chunked_apply(lambda t: (t * 2, t.sum(axis=1)), jnp.asarray(x.numpy()),
                                max_chunk=100)
    np.testing.assert_allclose(parts["a" if kind == "dict" else 0].numpy(),
                               np.asarray(jout[0]), atol=1e-5)


def test_get_samples_against_jax():
    for r, a, b in ((3, 0.0, 1.0), (8, -0.5, None), (1, 0.2, 0.7)):
        got = apply.get_samples(r, a, b).numpy()
        want = np.asarray(japply.get_samples(r, a, b))
        np.testing.assert_allclose(got, want, atol=1e-7)
    s = apply.get_samples(3, a=0.0, b=1.0).numpy()
    assert np.allclose(s[1], [0, 0, 0.5])          # x-major: z varies fastest


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_groupby_reduce_against_jax(op):
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 7, 200)
    idx[idx == 3] = 4                                 # an empty group
    vals = rng.randn(200, 6).astype(np.float32)
    valid = rng.rand(200) < 0.8
    got = apply.groupby_reduce(torch.as_tensor(idx), torch.as_tensor(vals), op, 7,
                               torch.as_tensor(valid))
    want = japply.groupby_reduce(jnp.asarray(idx), jnp.asarray(vals), op, 7,
                                 jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        apply.groupby_reduce(torch.tensor([0, 1, 0, 2, 1]),
                             torch.tensor([[1.0], [2.0], [3.0], [4.0], [6.0]]),
                             "mean", 3)[:, 0].numpy(), [2.0, 4.0, 4.0])


def test_pack_rows_equals_jax_on_its_draws():
    """The deterministic part on JAX's own permutation and selection."""
    rng = np.random.RandomState(2)
    idx = jnp.asarray(rng.randint(0, 6, 50)).at[jnp.asarray([0, 1])].set(5)
    idx = jnp.where(idx == 2, 3, idx)                 # segment 2 empty
    vals = jnp.asarray(rng.randn(50, 3).astype(np.float32))
    key = jax.random.PRNGKey(3)
    packed, gvalid = japply.pack_samples(idx, 4, vals, num_segments=6, rng=key)
    # JAX's draws, as pack_samples makes them
    perm = jnp.lexsort((jax.random.uniform(key, (50,)), idx))
    sel = jax.random.randint(key, (6, 4), 0, 1 << 30)
    got, gv = apply.pack_rows(torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(vals)),
                              6, torch.tensor(np.asarray(perm)).long(),
                              torch.tensor(np.asarray(sel)).long())
    assert torch.equal(got, torch.tensor(np.asarray(packed)))
    assert gv.tolist() == np.asarray(gvalid).tolist()


def test_pack_samples_membership():
    idx = torch.tensor([0, 0, 1, 1, 1, 3])
    vals = torch.tensor([[0.0], [1.0], [10.0], [11.0], [12.0], [30.0]])
    packed, gvalid = apply.pack_samples(idx, 4, vals, 4, torch.Generator().manual_seed(0))
    assert packed.shape == (4, 4, 1) and gvalid.tolist() == [True, True, False, True]
    assert set(packed[0].flatten().tolist()) <= {0.0, 1.0}
    assert set(packed[1].flatten().tolist()) <= {10.0, 11.0, 12.0}
    assert set(packed[3].flatten().tolist()) == {30.0}


# -- zoo --------------------------------------------------------------------


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("last_act", [False, True])
def test_mlp_against_jax(bn, last_act):
    dims = [6, 32, 16, 5]
    params = _np(jzoo.init_mlp(jax.random.PRNGKey(0), dims, bn=bn))
    if bn:   # non-trivial norm state
        params["norm0"]["scale"] = np.linspace(0.5, 1.5, 32).astype(np.float32)
        params["norm1"]["bias"] = np.linspace(-0.2, 0.2, 16).astype(np.float32)
    x = np.random.RandomState(4).randn(3, 7, 6).astype(np.float32)
    net = mlp_from_jax(params, dims, bn=bn, last_act=last_act)
    assert ("layer0.b" in dict(net.named_parameters())) == (not bn)
    got = net(torch.as_tensor(x)).detach().numpy()
    want = np.asarray(jzoo.apply_mlp(params, dims, jnp.asarray(x), last_act=last_act))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", [None, "mean", "max"])
def test_shared_mlp_pooling_against_jax(pool):
    dims = [6, 16, 8]
    params = _np(jzoo.init_shared_mlp(jax.random.PRNGKey(1), dims))
    rng = np.random.RandomState(5)
    pts = rng.randn(4, 9, 6).astype(np.float32)
    mask = rng.rand(4, 9) < 0.6
    mask[2] = False                                   # an empty set
    net = mlp_from_jax(params, dims, shared=True)
    got = net(torch.as_tensor(pts), torch.as_tensor(mask), pool=pool).detach().numpy()
    want = np.asarray(jzoo.apply_shared_mlp(params, dims, jnp.asarray(pts), pool=pool,
                                            point_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if pool == "max":
        assert np.all(got[2] == -np.inf)
    if pool == "mean":
        assert np.all(got[2] == 0.0)


# -- rays -------------------------------------------------------------------


def _pose(seed):
    from nerf_fusion_tpu_torch.utils.se3 import Isometry

    rng = np.random.RandomState(seed)
    iso = Isometry.from_twist(rng.randn(6) * 0.7)
    return (np.asarray(iso.q.rotation_matrix, np.float32), np.asarray(iso.t, np.float32))


@pytest.mark.parametrize("lindisp", [False, True])
def test_rays_against_jax(lindisp):
    R, t = _pose(0)
    args = (16, 12, 10.0, 11.0, 7.5, 5.5, 0.5, 4.0)
    got = rays.gen_rays(torch.as_tensor(R), torch.as_tensor(t), *args)
    want = jrays.gen_rays(jnp.asarray(R), jnp.asarray(t), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    pts, z = rays.sample_along_rays(got, 5, lindisp=lindisp)
    jpts, jz = jrays.sample_along_rays(want, 5, lindisp=lindisp)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    q = np.concatenate([pts.reshape(-1, 3).numpy(), t[None]], 0)   # the centre: z = 0
    uv, zz, front = rays.project_points(torch.as_tensor(q), torch.as_tensor(R),
                                        torch.as_tensor(t), 10.0, 11.0, 7.5, 5.5)
    juv, jzz, jfront = jrays.project_points(jnp.asarray(q), jnp.asarray(R), jnp.asarray(t),
                                            10.0, 11.0, 7.5, 5.5)
    np.testing.assert_allclose(uv.numpy()[:-1], np.asarray(juv)[:-1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(zz.numpy(), np.asarray(jzz), atol=1e-5)
    assert front.tolist() == np.asarray(jfront).tolist()
    # a ray's points project back to its pixel
    uv0, _, f0 = rays.project_points(pts[5, 7], torch.as_tensor(R), torch.as_tensor(t),
                                     10.0, 11.0, 7.5, 5.5)
    np.testing.assert_allclose(uv0.numpy(), [[7.0, 5.0]] * 5, atol=1e-3)
    assert bool(f0.all())


# -- image encoders -----------------------------------------------------------


@pytest.mark.parametrize("size,k,stride", [(32, 7, 2), (33, 7, 2), (32, 3, 2), (33, 3, 2),
                                           (31, 3, 1), (8, 1, 2)])
def test_same_padding_is_xlas(size, k, stride):
    rng = np.random.RandomState(size + k)
    x = rng.randn(1, 2, size, size + 1).astype(np.float32)
    w = rng.randn(3, 2, k, k).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    got = ie.conv2d_same(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b), stride)
    want = jie.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride)
    _close_rel(got.numpy(), want)
    if size % 2 == 0 and stride == 2 and k > 1:
        # nn.Conv2d's symmetric padding shifts a stride-2 output: not XLA's
        sym = F.conv2d(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b), 2, k // 2)
        assert sym.shape == got.shape
        assert float((sym - got).abs().max()) > 1e-2


@pytest.mark.parametrize("shape", [(2, 8, 5, 7), (1, 12, 4, 4), (1, 3, 6, 2)])
def test_group_norm_against_jax(shape):
    x = np.random.RandomState(6).randn(*shape).astype(np.float32) * 3 + 1
    _close_rel(ie.group_norm(torch.as_tensor(x)).numpy(), jie.group_norm(jnp.asarray(x)))


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((1, 7), (4, 9)), ((5, 1), (3, 3)),
                                     ((6, 4), (1, 1)), ((3, 3), (3, 3)), ((4, 6), (2, 3))])
def test_resize_bilinear_against_jax(src, dst):
    x = np.random.RandomState(7).randn(2, 3, *src).astype(np.float32)
    got = ie.resize_bilinear(torch.as_tensor(x), *dst).numpy()
    want = np.asarray(jie._resize_bilinear(jnp.asarray(x), *dst))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_index_features_against_jax_in_and_out_of_range():
    rng = np.random.RandomState(8)
    lat = rng.randn(2, 5, 16, 20).astype(np.float32)
    uv = np.concatenate([rng.uniform(0, [39, 31], (2, 30, 2)),
                         rng.uniform(-25, 70, (2, 30, 2)),             # many outside
                         np.array([[[0, 0], [39, 31], [-3, 40], [45, -1]]] * 2)],
                        1).astype(np.float32)
    got = ie.index_features(torch.as_tensor(lat), torch.as_tensor(uv), (32, 40)).numpy()
    want = np.asarray(jie.index_features(jnp.asarray(lat), jnp.asarray(uv), (32, 40)))
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


ENCODER_CASES = {
    "spatial": dict(channels=(8, 16), latent_size=24),
    "global": dict(channels=(8, 16), latent_size=12),
    "conv": dict(channels=(8, 16), out_channels=6),
    "resnet18": dict(depth=18, num_stages=4),
    "resnet34": dict(depth=34, num_stages=3),
}
def _randomise_bn(tree, rng):
    """Non-trivial frozen BN state in a JAX backbone pytree."""
    for v in tree.values():
        if isinstance(v, dict) and "mean" in v:
            c = v["mean"].shape[0]
            v.update(mean=rng.normal(0, 0.1, c).astype(np.float32),
                     var=rng.uniform(0.5, 1.5, c).astype(np.float32),
                     scale=rng.normal(1.0, 0.1, c).astype(np.float32))
        elif isinstance(v, dict):
            _randomise_bn(v, rng)


# the conv encoder's skip connections need sizes divisible by 4: even only
@pytest.mark.parametrize("name,hw", [(n, hw) for n in sorted(ENCODER_CASES)
                                     for hw in ((32, 40), (33, 41))
                                     if not (n == "conv" and hw[0] % 4)])
def test_image_encoders_against_jax(name, hw):
    enc_type = "resnet" if name.startswith("resnet") else name
    kw = ENCODER_CASES[name]
    cfg, params, apply_fn = jie.make_encoder(enc_type, key=jax.random.PRNGKey(0), **kw)
    params = _np(params)
    _randomise_bn(params, np.random.RandomState(9))
    img = np.random.RandomState(10).randn(2, 3, *hw).astype(np.float32)
    net = img_encoder_from_jax(enc_type, params, **kw)
    with torch.no_grad():
        got = net(torch.as_tensor(img)).numpy()
    _close_rel(got, apply_fn(params, cfg, jnp.asarray(img)))


def _torchvision_resnet18():
    """torchvision's resnet18 layout (module and key names) with random
    weights and BN statistics; torchvision itself is not installed."""
    from torch import nn

    class Block(nn.Module):
        def __init__(self, c_in, c_out, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(c_out)
            self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(c_out)
            self.downsample = None
            if stride != 1 or c_in != c_out:
                self.downsample = nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                                                nn.BatchNorm2d(c_out))

    net = nn.Module()
    net.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
    net.bn1 = nn.BatchNorm2d(64)
    for li, (c_in, c_out, s) in enumerate(((64, 64, 1), (64, 128, 2), (128, 256, 2),
                                           (256, 512, 2)), start=1):
        setattr(net, f"layer{li}", nn.Sequential(Block(c_in, c_out, s), Block(c_out, c_out, 1)))
    net.fc = nn.Linear(512, 1000)
    torch.manual_seed(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
    return net


def test_import_torch_backbone_against_jax():
    sd = _torchvision_resnet18().state_dict()
    x = np.random.RandomState(11).randn(2, 3, 64, 80).astype(np.float32)
    net = ie.import_torch_backbone(sd, depth=18)
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
    jparams = jie.import_torch_backbone(sd, depth=18)
    want = jie.apply_resnet_backbone(jparams, jie.ResNetBackboneConfig(depth=18, num_stages=4),
                                     jnp.asarray(x))
    assert got.shape == (2, 512, 32, 40)
    _close_rel(got, want)


def test_make_encoder_shapes():
    out = ie.make_encoder("resnet", depth=18, num_stages=4)(torch.zeros(1, 3, 32, 32))
    assert out.shape == (1, 64 + 64 + 128 + 256, 16, 16)
    assert "layer3.5.conv1.weight" in ie.make_encoder("resnet", depth=34).state_dict()
    assert ie.make_encoder("spatial", channels=(8, 16), latent_size=24)(
        torch.ones(1, 3, 16, 16)).shape[1] == 24
    with pytest.raises(NotImplementedError):
        ie.make_encoder("vit")


# -- the encoders in a training loop (tests/test_imgenc_e2e.py) ---------------


def _frame(w=64, h=48):
    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence

    seq = SyntheticSequence(n_frames=2, width=w, height=h)
    return next(seq), seq.calib


def test_index_features_at_projected_uv():
    """A latent that stores each feature pixel's coordinates returns the
    scaled uv of ``project_points`` for points on the depth surface."""
    f, c = _frame()
    H, W = f.depth.shape
    h, w = H // 2, W // 2
    lat = torch.stack([torch.arange(w, dtype=torch.float32).expand(h, w),
                       torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)])[None]
    us, vs = np.array([5, 20, 40, 60]), np.array([4, 12, 30, 44])
    z = f.depth.numpy()[vs, us]
    R = np.asarray(f.gt_pose.q.rotation_matrix)
    t = np.asarray(f.gt_pose.t)
    p_world = np.stack([(us - c.cx) / c.fx * z, (vs - c.cy) / c.fy * z, z], -1) @ R.T + t
    uv, _, front = rays.project_points(torch.as_tensor(p_world, dtype=torch.float32),
                                       torch.as_tensor(R, dtype=torch.float32),
                                       torch.as_tensor(t, dtype=torch.float32),
                                       c.fx, c.fy, c.cx, c.cy)
    np.testing.assert_allclose(uv.numpy(), np.stack([us, vs], -1), atol=1e-2)
    assert bool(front.all())
    got = ie.index_features(lat, uv[None], (H, W))[0].numpy()
    np.testing.assert_allclose(got[0], uv[:, 0].numpy() * (w - 1) / (W - 1), atol=1e-3)
    np.testing.assert_allclose(got[1], uv[:, 1].numpy() * (h - 1) / (H - 1), atol=1e-3)


def test_spatial_encoder_trains_end_to_end():
    """SpatialEncoder + a head regress each query point's signed offset from
    the depth surface through ``project_points`` and ``index_features``; the
    loss falls more than fivefold and the conv stack moves."""
    f, c = _frame()
    H, W = f.depth.shape
    depth = f.depth.numpy()
    R = np.asarray(f.gt_pose.q.rotation_matrix, np.float32)
    t = np.asarray(f.gt_pose.t, np.float32)
    rng = np.random.RandomState(0)
    vs, us = rng.randint(2, H - 2, 256), rng.randint(2, W - 2, 256)
    z = depth[vs, us]
    ok = np.isfinite(z)
    us, vs, z = us[ok], vs[ok], z[ok]
    delta = rng.uniform(-0.2, 0.2, len(z)).astype(np.float32)
    zq = z + delta
    p_world = (np.stack([(us - c.cx) / c.fx * zq, (vs - c.cy) / c.fy * zq, zq], -1) @ R.T
               + t).astype(np.float32)

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    enc = ie.SpatialEncoder(ie.SpatialEncoderConfig(channels=(8, 16), latent_size=24), gen)
    head = torch.nn.Sequential(torch.nn.Linear(25, 32), torch.nn.Tanh(), torch.nn.Linear(32, 1))
    start = [p.detach().clone() for p in enc.parameters()]
    img = f.rgb.permute(2, 0, 1)[None].float()
    pts, tgt = torch.as_tensor(p_world), torch.as_tensor(delta)
    Rt, tt = torch.as_tensor(R), torch.as_tensor(t)

    def loss_fn():
        lat = enc(img)
        uv, zz, _ = rays.project_points(pts, Rt, tt, c.fx, c.fy, c.cx, c.cy)
        feat = ie.index_features(lat, uv[None], (H, W))[0].T
        pred = head(torch.cat([feat, zz[:, None]], -1))[:, 0]
        return ((pred - tgt) ** 2).mean()

    opt = torch.optim.Adam(list(enc.parameters()) + list(head.parameters()), lr=3e-3)
    with torch.no_grad():
        l0 = float(loss_fn())
    for _ in range(120):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
    with torch.no_grad():
        l1 = float(loss_fn())
    assert np.isfinite(l1) and l1 < l0 / 5.0, (l0, l1)
    assert max(float((a - b).abs().max()) for a, b in zip(enc.parameters(), start)) > 0.0
