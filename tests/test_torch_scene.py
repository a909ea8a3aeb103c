"""The port's per-scene trainer against the JAX package's ``trainer/scene.py``.

The harvest on a 5-frame 160x120 synthetic sequence rendered by the JAX
package (the same float frames to both): the same LIFs over the same
voxels; positions, SDF targets and voxel bounds within 1e-5 (the
frontends' points are bitwise equal; payloads are in voxel units, 1e-5 is
1e-6 m at the config's 0.1 m voxel).  The normals follow the frontend's
own contract (``tests/test_torch_frontend.py``: directions within 0.999
on 99 % of the points): the port's stencil takes them in closed form where
JAX runs an eigensolver, and a near-degenerate neighbourhood can turn one
by 0.3.  The query points (point + jitter x normal) inherit that: within
1e-4 of one of JAX's on 99 % of the rows, a row jittered across a LIF's
border joining one package's LIF and not the other's.  On the
ScanNet-layout disk fixture of ``tests/test_scene_trainer.py``, read by
each package's reader, points on box-filter cell borders differ (see that
test); there the surface positions are held, and with the JAX frontend's
output handed to the port's harvest every column is within 1e-5, as on
the synthetic frames.
``MemoryLifDataset`` batches are bitwise JAX's for one seed.
Then the threshold plumbing, a one-epoch ``train_scene`` on the CPU and
the entry point.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.scannet import ScanNetSequence as JScanNetSequence
from nerf_fusion_tpu.data.synth import SyntheticSequence as JSyntheticSequence
from nerf_fusion_tpu.trainer import scene as jscene
from nerf_fusion_tpu.utils.config import parse_config_yaml as jparse_config_yaml
from nerf_fusion_tpu_torch import scene_trainer
from nerf_fusion_tpu_torch.data.scannet import ScanNetSequence
from nerf_fusion_tpu_torch.trainer import scene
from nerf_fusion_tpu_torch.utils.config import parse_config_yaml

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "train_scannet.yaml"
TOL = 1e-5          # positions, SDF, voxel bounds (voxel units)
TOL_NORMAL = 1e-4   # query points jittered along the normals
VOXEL = 0.1         # the config's mapping voxel_size


class _Frames:
    """A sequence over a list of frames (the same frames for both packages)."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def __len__(self):
        return len(self.frames)

    def __next__(self):
        self.i += 1
        return self.frames[self.i - 1]


@pytest.fixture(scope="module")
def synth_frames():
    seq = JSyntheticSequence(n_frames=5, width=160, height=120)
    frames = [seq.render_frame(i) for i in range(5)]
    for f in frames:
        f.rgb, f.depth = np.asarray(f.rgb), np.asarray(f.depth)
    return frames


@pytest.fixture(scope="module")
def scene_dir(synth_frames, tmp_path_factory):
    """The ScanNet export layout of ``tests/test_scene_trainer.py``."""
    import cv2

    out = tmp_path_factory.mktemp("scene")
    for d in ("color", "depth", "pose", "intrinsic"):
        (out / d).mkdir()
    for i, f in enumerate(synth_frames):
        rgb = (np.clip(f.rgb, 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(out / "color" / f"{i}.jpg"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        d16 = np.nan_to_num(f.depth, nan=0.0) * 1000
        cv2.imwrite(str(out / "depth" / f"{i}.png"), d16.astype(np.uint16))
        np.savetxt(out / "pose" / f"{i}.txt", f.gt_pose.matrix)
    c = synth_frames[0].calib
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = c.fx, c.fy, c.cx, c.cy
    np.savetxt(out / "intrinsic" / "intrinsic_depth.txt", K)
    return out


def _args(pre=None):
    args, jargs = parse_config_yaml(CONFIG), jparse_config_yaml(CONFIG)
    if pre is not None:
        args.preprocess, jargs.preprocess = dict(pre), dict(pre)
    return args, jargs


def _near(x, y, tol):
    """Per row of ``x``: a row of ``y`` within ``tol`` (Chebyshev)."""
    from scipy.spatial import cKDTree

    return cKDTree(y).query(x, p=np.inf)[0] <= tol


def _same_lifs(got, want, mode="normals"):
    """The same LIFs over the same voxels, and:
    ``exact``: every column within TOL;
    ``normals``: surface positions within TOL, normals within 0.999 in
    direction and query rows (xyz, SDF) within TOL_NORMAL of a row of the
    other package's LIF, both on 99 % of the rows of all LIFs together;
    ``cells``: 95 % of the voxels in both, and in those the surface
    positions within TOL of one of the other's on 99 % of the rows (a point
    on a box-filter cell border lands in the other cell, and the points
    after it in the frame's list are taken in another order, so their
    jitters are other draws and a voxel's filters may decide otherwise)."""
    if mode == "cells":
        # the LIFs of the voxels both harvests keep
        keys = lambda lifs: {tuple(np.round(l["min"] / VOXEL).astype(int)): l for l in lifs}
        kg, kw = keys(got), keys(want)
        common = sorted(set(kg) & set(kw))
        assert len(common) >= 0.95 * max(len(kg), len(kw))     # measured: 68 of 69
        got, want = [kg[k] for k in common], [kw[k] for k in common]
    assert len(got) == len(want) > 5
    dots, near = [], []
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in ("min", "max"):
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0)
        if mode == "exact":
            for k in ("surface", "data"):
                np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0)
        elif mode == "normals":
            np.testing.assert_allclose(a["surface"][:, :3], b["surface"][:, :3], atol=TOL, rtol=0)
            dots.append(np.sum(a["surface"][:, 3:] * b["surface"][:, 3:], -1) > 0.999)
            near += [_near(a["data"], b["data"], TOL_NORMAL), _near(b["data"], a["data"],
                                                                     TOL_NORMAL)]
        else:
            near += [_near(a["surface"][:, :3], b["surface"][:, :3], TOL),
                     _near(b["surface"][:, :3], a["surface"][:, :3], TOL)]
    if dots:
        assert np.mean(np.concatenate(dots)) >= 0.99
    if near:
        assert np.mean(np.concatenate(near)) >= 0.99


@pytest.mark.parametrize("pre", [{"outlier_min_nb": 8}, None], ids=["min_nb_8", "defaults"])
def test_harvest_synthetic_against_jax(synth_frames, pre):
    args, jargs = _args(pre)
    got = scene.harvest_scene_lifs(_Frames(synth_frames), args, frame_stride=1, device="cpu")
    want = jscene.harvest_scene_lifs(_Frames(synth_frames), jargs, frame_stride=1)
    assert got.keyframes == 5 and got.drop_frac.shape == (5,)
    _same_lifs(got.lifs, want)


def test_harvest_on_the_jax_frontend_output(synth_frames, monkeypatch):
    """The harvest's own work (world frame, jitter draws, split) on the JAX
    frontend's points and normals: every column within 1e-5."""
    monkeypatch.setattr(scene, "preprocess_frame", _jax_frontend)
    args, jargs = _args({"outlier_min_nb": 8})
    got = scene.harvest_scene_lifs(_Frames(synth_frames), args, frame_stride=1, device="cpu")
    want = jscene.harvest_scene_lifs(_Frames(synth_frames), jargs, frame_stride=1)
    _same_lifs(got.lifs, want, "exact")


def _jax_frontend(rgb, depth, *a, **kw):
    """The JAX package's ``preprocess_frame`` in the port's types."""
    import jax.numpy as jnp

    from nerf_fusion_tpu.system.frontend import preprocess_frame as jpreprocess
    from nerf_fusion_tpu_torch.system.frontend import Preprocessed

    p = jpreprocess(jnp.asarray(rgb.numpy()), jnp.asarray(depth.numpy()), *a, **kw)
    t = lambda x: torch.as_tensor(np.array(x))
    return Preprocessed(None, t(p.points), t(p.normals), t(p.colors), t(p.mask), t(p.drop_frac))


def test_harvest_scannet_fixture_against_jax(scene_dir, monkeypatch):
    """Each package's reader on the fixture's JPEG / 16-bit PNG frames.  The
    depths are whole millimetres, so many points lie on the box filter's
    2 cm cell borders, and XLA on the CPU divides by the cell size as a
    product with its reciprocal: a border point falls in the other cell.
    So the port's own frontend is held by its surface positions; with the
    JAX frontend's output the harvest is held in every column."""
    args, jargs = _args({"outlier_min_nb": 8})
    kw = dict(max_frames=5, frame_stride=1)
    want = jscene.harvest_scene_lifs(JScanNetSequence(str(scene_dir)), jargs, **kw)
    got = scene.harvest_scene_lifs(ScanNetSequence(str(scene_dir)), args, device="cpu", **kw)
    assert got.keyframes == 5 and got.points > 0 and np.all(got.drop_frac == 0.0)
    _same_lifs(got.lifs, want, "cells")
    monkeypatch.setattr(scene, "preprocess_frame", _jax_frontend)
    got = scene.harvest_scene_lifs(ScanNetSequence(str(scene_dir)), args, device="cpu", **kw)
    _same_lifs(got.lifs, want, "exact")


def test_harvest_needs_poses(synth_frames):
    frames = [f for f in synth_frames[:2]]
    posed = frames[0].gt_pose
    try:
        frames[0].gt_pose = None
        with pytest.raises(ValueError, match="poses"):
            scene.harvest_scene_lifs(_Frames(frames), _args()[0], device="cpu")
    finally:
        frames[0].gt_pose = posed


def test_memory_dataset_batches_bitwise(synth_frames):
    args, jargs = _args({"outlier_min_nb": 8})
    lifs = jscene.harvest_scene_lifs(_Frames(synth_frames), jargs, frame_stride=1)
    kw = dict(num_sample=256, num_surface_sample=32, augment_rotation="Y",
              augment_noise=(0.01, 20.0), seed=3)
    ds, jds = scene.MemoryLifDataset(lifs, **kw), jscene.MemoryLifDataset(lifs, **kw)
    assert ds.data_path is None and len(ds) == len(jds)
    rng = np.random.RandomState(0)
    for _ in range(3):
        idx = rng.randint(0, len(ds), 6)
        for a, b in zip(ds.sample_batch(idx), jds.sample_batch(idx)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_preprocess_plumbing():
    args = _args()[0]
    assert scene.preprocess_kwargs(args) == {}
    args.tracking = {"preprocess": {"outlier_min_nb": 8.0, "normal_radius": 1, "x": 3}}
    kw = scene.preprocess_kwargs(args)
    assert kw == {"outlier_min_nb": 8, "normal_radius": 1.0}
    assert type(kw["outlier_min_nb"]) is int and type(kw["normal_radius"]) is float
    # a top-level block wins, as a namespace too
    from argparse import Namespace

    args.preprocess = Namespace(outlier_radius=0.07, normal_min_nb=3.0)
    assert scene.preprocess_kwargs(args) == {"outlier_radius": 0.07, "normal_min_nb": 3}


def _small(tmp_path, run):
    return (f"save_dir='{tmp_path}';run_name='{run}';num_epochs=1;max_steps_per_epoch=2;"
            "batch_size=4;samples_per_lif=128;snapshot_frequency=1;additional_snapshots=[];"
            "preprocess={'outlier_min_nb': 8}")


def test_train_scene_one_epoch(scene_dir, tmp_path):
    from nerf_fusion_tpu_torch.utils.config import apply_exec

    args = _args()[0]
    apply_exec(args, _small(tmp_path, "scene"))
    steps = []
    model, save_dir = scene.train_scene(args, ScanNetSequence(str(scene_dir)), max_frames=5,
                                        device="cpu", step_hook=steps.append)
    assert steps == [1, 2]
    for name in ("hyper.json", "model_1.npz", "encoder_1.npz", "optimizer_1.pt",
                 "harvest.json"):
        assert (save_dir / name).exists(), name
    import json

    h = json.loads((save_dir / "harvest.json").read_text())
    assert h["keyframes"] == 1 and h["lifs"] > 0 and len(h["drop_frac"]) == 1


def test_entry_cpu_and_no_gpu(tmp_path):
    ex = ("sequence_kwargs['width']=160;sequence_kwargs['height']=120;"
          + _small(tmp_path, "entry"))
    save = scene_trainer.main([str(CONFIG), "--device", "cpu", "--max_frames", "10",
                               "--exec", ex])
    assert (save / "model_1.npz").exists() and (save / "harvest.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scene_trainer.main([str(CONFIG), "--exec", ex])
