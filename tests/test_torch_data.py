"""The port's data layer against the JAX package's.

The exporter, the ICL-NUIM and ScanNet readers, the prefetcher and the
large synthetic scene, each fed the same inputs as its JAX counterpart.
Both packages decode and encode PNGs with OpenCV, so images and poses are
held exactly; the renderers within the tolerances of
``test_torch_synth.py``: 96 sphere-trace steps in f32 on both sides round
differently, so depth agrees to 1e-4 m where both hit and the hit masks
on all but 0.1 % of the pixels.
"""

import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data import synth as jsynth
from nerf_fusion_tpu.data.icl_nuim import ICLNUIMSequence as JaxICL
from nerf_fusion_tpu.data.scannet import ScanNetSequence as JaxScanNet
from nerf_fusion_tpu_torch import main as entry
from nerf_fusion_tpu_torch.data import synth
from nerf_fusion_tpu_torch.data.base import FrameData, FrameIntrinsic
from nerf_fusion_tpu_torch.data.icl_nuim import ICLNUIMSequence
from nerf_fusion_tpu_torch.data.prefetch import PrefetchSequence
from nerf_fusion_tpu_torch.data.scannet import ScanNetSequence
from nerf_fusion_tpu_torch.tools import export_icl_format as texport
from nerf_fusion_tpu_torch.utils.config import parse_config_yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import export_icl_format as jexport  # noqa: E402  (the JAX repository's tool)


class _Frames:
    """A sequence over a list of frames (``len`` and ``next``)."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def __len__(self):
        return len(self.frames)

    def __next__(self):
        self.i += 1
        return self.frames[self.i - 1]


def _jax_frames(n=6, w=160, h=120):
    seq = jsynth.SyntheticSequence(n_frames=n, width=w, height=h)
    out = []
    for i in range(n):
        f = seq.render_frame(i)
        g = FrameData()
        g.rgb, g.depth = np.asarray(f.rgb), np.asarray(f.depth)
        g.gt_pose, g.calib = f.gt_pose, f.calib
        out.append(g)
    return out


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The same six 160x120 frames written by both exporters."""
    frames = _jax_frames()
    jdir, tdir = tmp_path_factory.mktemp("jax_icl"), tmp_path_factory.mktemp("torch_icl")
    jtq = jexport.export_sequence(_Frames(frames), jdir)
    ttq = texport.export_sequence(_Frames(frames), tdir)
    return dict(frames=frames, jdir=jdir, tdir=tdir, jtq=jtq, ttq=ttq)


def _read(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def test_exporter_matches_jax(exports):
    jdir, tdir = exports["jdir"], exports["tdir"]
    assert exports["ttq"] == exports["jtq"]
    np.testing.assert_array_equal(np.loadtxt(tdir / "groundtruth.freiburg"),
                                  np.loadtxt(jdir / "groundtruth.freiburg"))
    for i in range(6):
        for kind in ("rgb", "depth"):
            a, b = _read(tdir / kind / f"{i}.png"), _read(jdir / kind / f"{i}.png")
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_encode_tum_pose_matches_jax(exports):
    for f in exports["frames"]:
        np.testing.assert_array_equal(texport.encode_tum_pose(f.gt_pose),
                                      jexport.encode_tum_pose(f.gt_pose))


def test_exporter_requantises_raw_depth(tmp_path):
    """uint16 counts at the source's scale (1000 / m) come out at 5000 / m,
    as the JAX exporter writes them."""
    frames = _jax_frames(n=3)
    for f in frames:
        d = np.nan_to_num(f.depth) * 1000.0
        f.depth = np.clip(d, 0, 65535).astype(np.uint16)
        f.rgb = (np.clip(f.rgb, 0, 1) * 255).astype(np.uint8)
        f.calib = FrameIntrinsic(f.calib.fx, f.calib.fy, f.calib.cx, f.calib.cy, 1000.0)
    jexport.export_sequence(_Frames(frames), tmp_path / "j")
    texport.export_sequence(_Frames(frames), tmp_path / "t")
    for i in range(3):
        a = _read(tmp_path / "t" / "depth" / f"{i}.png")
        np.testing.assert_array_equal(a, _read(tmp_path / "j" / "depth" / f"{i}.png"))
        assert a.dtype == np.uint16 and a.max() > 0


@pytest.mark.parametrize("first_tq", ["exported", None])
def test_icl_reader_matches_jax(exports, first_tq):
    tq = exports["ttq"] if first_tq == "exported" else None
    t = ICLNUIMSequence(str(exports["tdir"]), first_tq=tq, load_gt=True)
    j = JaxICL(str(exports["tdir"]), first_tq=tq, load_gt=True)
    assert len(t) == len(j) == 6
    assert np.abs(t.first_iso.matrix - j.first_iso.matrix).max() <= 1e-9
    for a, b in zip(t.gt_trajectory, j.gt_trajectory):
        assert np.abs(a.matrix - b.matrix).max() <= 1e-9
    for i in range(6):
        a, b = next(t), next(j)
        assert a.rgb.dtype == np.uint8 and a.depth.dtype == np.uint16
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
        assert vars(a.calib) == vars(b.calib)
    with pytest.raises(StopIteration):
        next(t)


def test_icl_reader_recovers_poses_and_slices(exports):
    """With the exported first_tq the ground truth is the rendered poses
    (frame 0 takes frame 1's, the reference parser's quirk); start and end
    frames slice as the JAX reader does."""
    frames = exports["frames"]
    rd = ICLNUIMSequence(str(exports["tdir"]), first_tq=exports["ttq"], load_gt=True)
    assert np.allclose(rd.gt_trajectory[0].matrix, frames[1].gt_pose.matrix, atol=1e-5)
    for gt, f in zip(rd.gt_trajectory[1:], frames[1:]):
        assert np.allclose(gt.matrix, f.gt_pose.matrix, atol=1e-5)
    t = ICLNUIMSequence(str(exports["tdir"]), start_frame=2, end_frame=5, load_gt=True)
    j = JaxICL(str(exports["tdir"]), start_frame=2, end_frame=5, load_gt=True)
    assert len(t) == len(j) == 3
    for a, b in zip(t.gt_trajectory, j.gt_trajectory):
        assert np.abs(a.matrix - b.matrix).max() <= 1e-9
    np.testing.assert_array_equal(t.load_frame(0).depth, j.load_frame(0).depth)


@pytest.fixture(scope="module")
def scannet_dir(tmp_path_factory):
    """ScanNet layout from five rendered frames: PNG colour at twice the
    depth size (so the reader resamples it), depth in millimetres, and an
    untracked (-inf) pose at frame 3."""
    out = tmp_path_factory.mktemp("scannet")
    for d in ("color", "depth", "pose", "intrinsic"):
        (out / d).mkdir()
    big = _jax_frames(n=5, w=320, h=240)
    small = _jax_frames(n=5)
    for i, (fb, fs) in enumerate(zip(big, small)):
        rgb = (np.clip(fb.rgb, 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(out / "color" / f"{i}.png"), rgb[..., ::-1])
        d16 = np.clip(np.nan_to_num(fs.depth) * 1000.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(str(out / "depth" / f"{i}.png"), d16)
        pose = np.full((4, 4), -np.inf) if i == 3 else fs.gt_pose.matrix
        np.savetxt(out / "pose" / f"{i}.txt", pose)
    c = small[0].calib
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = c.fx, c.fy, c.cx, c.cy
    np.savetxt(out / "intrinsic" / "intrinsic_depth.txt", K)
    return out, small


@pytest.mark.parametrize("frame_skip", [1, 2])
def test_scannet_reader_matches_jax(scannet_dir, frame_skip):
    out, small = scannet_dir
    t = ScanNetSequence(str(out), frame_skip=frame_skip)
    j = JaxScanNet(str(out), frame_skip=frame_skip)
    assert len(t) == len(j) == (5 if frame_skip == 1 else 3)
    assert vars(t.calib) == vars(j.calib)
    for a, b in zip(t.gt_trajectory, j.gt_trajectory):
        np.testing.assert_array_equal(a.matrix, b.matrix)
    if frame_skip == 1:
        # the untracked frame repeats the previous pose
        np.testing.assert_array_equal(t.gt_trajectory[3].matrix, t.gt_trajectory[2].matrix)
        assert np.allclose(t.gt_trajectory[4].matrix, small[4].gt_pose.matrix, atol=1e-6)
    for i in range(len(t)):
        a, b = next(t), next(j)
        assert a.rgb.shape == (120, 160, 3) and a.rgb.dtype == np.uint8
        assert a.depth.dtype == np.uint16
        # colour resampled to the depth grid by the same area filter: exact
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)


def test_reader_names_a_missing_file(tmp_path, exports):
    rd = ICLNUIMSequence(str(exports["tdir"]))
    rd.depth_names = ["depth/missing.png"] * len(rd)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        rd.load_frame(0)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_prefetch_matches_direct(exports, workers):
    direct = ICLNUIMSequence(str(exports["tdir"]), first_tq=exports["ttq"], load_gt=True)
    pre = PrefetchSequence(
        ICLNUIMSequence(str(exports["tdir"]), first_tq=exports["ttq"], load_gt=True),
        depth=3, workers=workers, device="cpu")
    assert len(pre) == 6 and pre.gt_trajectory is not None
    for _ in range(6):
        a, b = next(direct), next(pre)
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.gt_pose.matrix, b.gt_pose.matrix)
    with pytest.raises(StopIteration):
        next(pre)
    pre.close()


def test_prefetch_sequential_fallback():
    """A sequence without ``load_frame`` goes through the one-worker ordered
    path and keeps its own attributes reachable."""
    ref = synth.SyntheticSequence(n_frames=4, width=64, height=48)
    pre = PrefetchSequence(synth.SyntheticSequence(n_frames=4, width=64, height=48),
                           depth=2, device="cpu")
    assert pre.scene_sdf is synth.scene_sdf and len(pre) == 4
    for i in range(4):
        a, b = ref.render_frame(i), next(pre)
        assert torch.equal(a.rgb, b.rgb) and torch.equal(a.depth.isnan(), b.depth.isnan())
    with pytest.raises(StopIteration):
        next(pre)
    pre.close()


def test_prefetch_upload_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        PrefetchSequence(synth.SyntheticSequence(n_frames=1, width=8, height=8),
                         upload=True, device="cpu")


def test_large_scene_sdf_matches_jax():
    p = np.random.RandomState(1).uniform(-4.8, 4.8, (20000, 3)).astype(np.float32)
    ref = np.asarray(jsynth.scene_sdf_large(jnp.asarray(p)))
    assert np.abs(synth.scene_sdf_large(torch.tensor(p)).numpy() - ref).max() <= 1e-6
    assert set(synth.SCENES) == set(jsynth.SCENES)


def test_large_scene_render_matches_jax():
    jseq = jsynth.SyntheticSequence(n_frames=9, width=96, height=72, scene="large")
    tseq = synth.SyntheticSequence(n_frames=9, width=96, height=72, scene="large")
    assert tseq.scene_sdf is synth.scene_sdf_large
    for i in (0, 4, 8):
        jf, tf = jseq.render_frame(i), tseq.render_frame(i)
        jd, td = np.asarray(jf.depth), tf.depth.numpy()
        jhit, thit = np.isfinite(jd), np.isfinite(td)
        assert jhit.mean() > 0.4
        assert np.mean(jhit != thit) <= 0.001
        both = jhit & thit
        assert np.abs(jd[both] - td[both]).max() <= 1e-4
        # colour away from the texture's checker edges (floor(3x), floor(3z)):
        # the outer walls x = +-4, z = +-4 lie on one, where the two
        # renderers' last-bit differences pick either cell
        c, iso = jf.calib, jf.gt_pose
        v, u = np.nonzero(both)
        z = jd[v, u]
        cam = np.stack([(u - c.cx) / c.fx * z, (v - c.cy) / c.fy * z, z], -1)
        world = cam @ np.asarray(iso.q.rotation_matrix).T + np.asarray(iso.t)
        cell = 3.0 * world[:, [0, 2]]
        away = (np.abs(cell - np.round(cell)) > 1e-2).all(-1)
        drgb = np.abs(np.asarray(jf.rgb)[v, u] - tf.rgb.numpy()[v, u]).max(-1)
        assert away.mean() > 0.5 and np.mean(drgb[away] > 1e-3) <= 0.001


def test_large_trajectory_matches_jax():
    jseq = jsynth.SyntheticSequence(n_frames=400, scene="large")
    tseq = synth.SyntheticSequence(n_frames=400, scene="large", seed=3)
    assert len(tseq) == 400
    for a, b in zip(jseq._poses, tseq._poses):
        np.testing.assert_array_equal(a.matrix, b.matrix)


def test_scannet_scale_config_builds_the_large_scene():
    args = parse_config_yaml(REPO / "configs" / "fusion-scannet-scale.yaml")
    args.sequence_kwargs.update(n_frames=3, width=32, height=24)
    seq = entry.build_sequence(args, "cpu")
    assert isinstance(seq, synth.SyntheticSequence)
    assert seq.scene_sdf is synth.scene_sdf_large and len(seq) == 3
    assert tuple(seq.render_frame(0).rgb.shape) == (24, 32, 3)


@pytest.mark.parametrize("prefetch", [True, False])
def test_build_sequence_wraps_readers(exports, prefetch):
    """A disk reader is built without ``device`` and wrapped in a
    ``PrefetchSequence`` (no upload on the CPU) unless ``prefetch: false``;
    the renderer gets the device and no wrapper."""
    args = parse_config_yaml(REPO / "configs" / "fusion-lr-kt.yaml")
    args.sequence_kwargs.update(path=str(exports["tdir"]), first_tq=exports["ttq"])
    args.prefetch = prefetch
    seq = entry.build_sequence(args, "cpu")
    if prefetch:
        assert isinstance(seq, PrefetchSequence) and not seq._upload
        assert isinstance(seq._base, ICLNUIMSequence)
        seq.close()
    else:
        assert isinstance(seq, ICLNUIMSequence)
    assert len(seq) == 6
    assert np.abs(seq.gt_trajectory[1].matrix - exports["frames"][1].gt_pose.matrix).max() < 1e-5
    args = parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    args.sequence_kwargs.update(n_frames=2, width=16, height=12)
    seq = entry.build_sequence(args, "cpu")
    assert isinstance(seq, synth.SyntheticSequence) and seq.device == torch.device("cpu")


def test_lrkt_export_helper(tmp_path):
    """``export_lrkt`` writes the room at the lr-kt span and returns the
    first_tq that reads it back in the renderer's world frame; a complete
    export is reused."""
    tq = texport.export_lrkt(tmp_path, device="cpu", n_frames=5, width=32, height=24)
    assert len(list((tmp_path / "rgb").glob("*.png"))) == 5
    seq = synth.SyntheticSequence(n_frames=5, angular_span=1.2 * 4 / 119.0, width=32,
                                  height=24)
    rd = ICLNUIMSequence(str(tmp_path), first_tq=tq, load_gt=True)
    for gt, p in zip(rd.gt_trajectory[1:], seq._poses[1:]):
        assert np.allclose(gt.matrix, p.matrix, atol=1e-5)
    stamp = (tmp_path / "rgb" / "0.png").stat().st_mtime_ns
    assert texport.export_lrkt(tmp_path, device="cpu", n_frames=5, width=32, height=24) == tq
    assert (tmp_path / "rgb" / "0.png").stat().st_mtime_ns == stamp
    assert texport.LRKT_SPAN == pytest.approx(1.2 * 169 / 119)
