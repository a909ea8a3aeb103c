"""The parity config through the ICL-NUIM disk format, port against JAX.

``configs/fusion-lr-kt.yaml`` as it is (dense stride-1 photometric term,
the reference's full-resolution intrinsics at every pyramid level) on the
synthetic room at the lr-kt export's camera motion, written in the
ICL-NUIM layout by the port's exporter and read back by each package's
own reader as raw uint8 / uint16 frames: 320x240, 9 frames, the reader's
calibration scaled by 1/2, integrate and mesh every 3 frames, shrunk
capacities.  At 160x120 (calibration / 4) the two agreed to 0.1 mm for
the first three frames and then drifted apart by up to 13.6 mm: the
reader's calibration (fy 480, cx 319.5) is not the renderer's (fy 481.2),
tracking there is 2-3 cm off the truth, and in that regime the GN early
exit picks neighbouring iterates (``test_torch_e2e.py``).  At 320x240 they
agree to 0.05 mm.

Tolerances as in ``test_torch_e2e.py`` and for the same reasons: per-frame
pose within 5 mm and 0.3 deg (the GN early exit may pick a neighbouring
iterate after an f32 rounding difference), ATE and mesh |SDF| within 1 mm
of JAX's.

Also here: the raw-frame frontend (uint8 rgb, uint16 depth counts)
bitwise equal to the float path on the same frame.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data import synth as jsynth
from nerf_fusion_tpu.data.icl_nuim import ICLNUIMSequence as JaxICL
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.system.pipeline import FusionPipeline as JaxPipeline
from nerf_fusion_tpu.utils.config import dict_to_args, parse_config_yaml
from nerf_fusion_tpu.utils.evaluate import ate_rmse as jax_ate
from nerf_fusion_tpu_torch.data.icl_nuim import ICLNUIMSequence
from nerf_fusion_tpu_torch.data.synth import scene_sdf
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.system.frontend import frame_to_float, preprocess_frame
from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
from nerf_fusion_tpu_torch.tools.export_icl_format import export_sequence
from nerf_fusion_tpu_torch.utils.evaluate import ate_rmse, mesh_abs_sdf_error

REPO = Path(__file__).resolve().parent.parent
CFG = REPO / "configs" / "fusion-lr-kt.yaml"
N_FRAMES = 9
SCALE = 0.5           # 320x240 frames, the reader's 640x480 calibration


def _args():
    args = parse_config_yaml(CFG)
    args.single_device = True
    args.integrate_interval = 3
    args.meshing_interval = 3
    args.max_n_triangles = 200000
    args.mapping = dict_to_args(args.mapping)
    args.mapping.latent_capacity = 4096
    args.mapping.alloc_capacity = 2048
    args.mapping.points_capacity = 8192
    args.tracking = dict_to_args(args.tracking)
    return args


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = tmp_path_factory.mktemp("lrkt")
    # the lr-kt export's camera motion per frame (its span over 119 intervals)
    seq = jsynth.SyntheticSequence(n_frames=N_FRAMES, width=320, height=240,
                                   angular_span=1.2 * (N_FRAMES - 1) / 119.0)
    return out, export_sequence(seq, out)


def _frames(reader):
    out = []
    for _ in range(len(reader)):
        f = next(reader)
        f.calib = f.calib.scaled(SCALE)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def runs(exported):
    path, tq = exported
    ja, ta = _args(), _args()
    assert ta.tracking.rgb["stride"] == 1 and not ta.tracking.rgb["scale_intrinsics"]
    jm, ja.model = jax_load_model(REPO / ja.training_hypers, 300)
    tm, ta.model = load_model(REPO / ta.training_hypers, 300)
    jp = JaxPipeline(jm, ja)
    tp = FusionPipeline(tm, ta, "cpu")
    assert tp.tracker.tcfg.rgb_stride == 1 and not tp.tracker.tcfg.scale_level_intrinsics
    jrd = JaxICL(str(path), first_tq=tq, load_gt=True)
    trd = ICLNUIMSequence(str(path), first_tq=tq, load_gt=True)
    for i, (jf, tf) in enumerate(zip(_frames(jrd), _frames(trd))):
        assert tf.rgb.dtype == np.uint8 and tf.depth.dtype == np.uint16
        jp.process_frame(jf, i)
        tp.process_frame(tf, i)
    # the lr-kt config gives no max_std: both pipelines' default
    jmesh = jp.mesher.extract(ja.resolution, max_std=0.15)
    tmesh = tp.mesher.extract(ta.resolution, max_std=0.15)
    gt = [p.t for p in trd.gt_trajectory]
    return dict(jtraj=jp.trajectory(), ttraj=tp.trajectory(), gt=gt, jmesh=jmesh,
                tmesh=tmesh)


def test_poses_match_jax(runs):
    assert len(runs["ttraj"]) == len(runs["jtraj"]) == N_FRAMES
    for j, t in zip(runs["jtraj"], runs["ttraj"]):
        assert np.linalg.norm(j.t - t.t) < 5e-3
        dR = j.q.rotation_matrix.T @ t.q.rotation_matrix
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.3


def test_ate_and_mesh_match_jax(runs):
    ate_j = jax_ate(runs["jtraj"], runs["gt"])
    ate_t = ate_rmse([p.t for p in runs["ttraj"]], runs["gt"])
    assert ate_t < 0.02 and abs(ate_t - ate_j) < 1e-3
    jm, tm = runs["jmesh"], runs["tmesh"]
    assert len(jm) > 200
    err_j = float(np.mean(np.abs(np.asarray(jsynth.scene_sdf(jm.reshape(-1, 3))))))
    err_t = mesh_abs_sdf_error(tm, scene_sdf)
    assert err_t < 0.03 and abs(err_t - err_j) < 1e-3


def test_raw_conversion_is_the_f32_division():
    """Every uint8 value / 255 and every uint16 count / 5000 and / 1000 as
    numpy's float32 division gives it; count 0 is NaN."""
    rgb = np.arange(256, dtype=np.uint8)
    counts = np.arange(65536, dtype=np.uint16)
    for dscale in (5000.0, 1000.0):
        r, d = frame_to_float(torch.from_numpy(rgb), torch.from_numpy(counts), dscale)
        assert r.dtype == d.dtype == torch.float32
        np.testing.assert_array_equal(r.numpy(), rgb.astype(np.float32) / np.float32(255.0))
        ref = counts.astype(np.float32) / np.float32(dscale)
        ref[0] = np.nan
        np.testing.assert_array_equal(d.numpy(), ref)


def test_raw_frame_path_equals_float_path(exported):
    """A frame as the reader gives it (uint8, uint16 at 5000 counts per
    metre) and the same frame converted on the host (float32 rgb / 255,
    depth / 5000 with NaN for 0): every output of ``preprocess_frame``
    bitwise equal."""
    path, tq = exported
    f = ICLNUIMSequence(str(path), first_tq=tq).load_frame(4)
    c = f.calib.scaled(SCALE)
    rgb_f = f.rgb.astype(np.float32) / np.float32(255.0)
    depth_f = np.where(f.depth == 0, np.float32(np.nan),
                       f.depth.astype(np.float32) / np.float32(c.dscale))
    raw = preprocess_frame(torch.from_numpy(f.rgb), torch.from_numpy(f.depth),
                           c.fx, c.fy, c.cx, c.cy, 0.5, 5.0, 8192, depth_scale=c.dscale)
    flt = preprocess_frame(torch.from_numpy(rgb_f), torch.from_numpy(depth_f),
                           c.fx, c.fy, c.cx, c.cy, 0.5, 5.0, 8192, depth_scale=c.dscale)
    flat = lambda p: [*p.pyramid.intensity, *p.pyramid.depth, *p.pyramid.gradient,  # noqa: E731
                      p.points, p.normals, p.colors, p.mask, p.drop_frac]
    assert int(raw.mask.sum()) > 100
    for a, b in zip(flat(raw), flat(flt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
