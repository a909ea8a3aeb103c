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
from nerf_fusion_tpu_torch.ops import cuda_build, mlp, stencil

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


def test_cpu_tensors_take_the_plain_path_and_count_nothing(model):
    before = (mlp.decoder_forward.launches, mlp.decoder_forward_grad.launches,
              mlp.encoder_forward.launches, stencil.normals_stencil.launches,
              stencil.neighbor_count.launches)
    x = torch.randn(40, 32)
    assert torch.equal(mlp.decoder_forward(x, model.decoder.packed, model.decoder.mats),
                       mlp.decoder_forward_plain(x, model.decoder.mats))
    mlp.decoder_forward_grad(x, model.decoder.packed, model.decoder.mats)
    mlp.encoder_forward(torch.randn(40, 6), model.encoder.packed, model.encoder.mats)
    pts, valid = _points("cpu")
    stencil.normals_stencil(pts, valid, 0.1)
    stencil.neighbor_count(pts, valid, 0.05)
    after = (mlp.decoder_forward.launches, mlp.decoder_forward_grad.launches,
             mlp.encoder_forward.launches, stencil.normals_stencil.launches,
             stencil.neighbor_count.launches)
    assert after == before


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


def test_build_flags_target_hopper():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu")) == sorted(
        cuda_build.SOURCES)
    assert cuda_build.library_path("mlp").parent == cuda_build.BUILD_DIR


@pytest.mark.cuda
def test_decoder_kernels_match_plain(cuda_device, model):
    dec = model.decoder.to(cuda_device)
    x = (0.4 * torch.randn(3001, 32)).to(cuda_device)
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


@pytest.mark.cuda
def test_encoder_kernel_matches_plain(cuda_device, model):
    enc = model.encoder.to(cuda_device)
    x = torch.randn(5000, 6).to(cuda_device)
    torch.testing.assert_close(mlp.encoder_forward(x, enc.packed, enc.mats),
                               mlp.encoder_forward_plain(x, enc.mats), atol=1e-4, rtol=0)


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
