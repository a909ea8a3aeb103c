"""The fast tracking path against the JAX pipeline.

The two deltas of ``configs/fusion-lr-kt-fast.yaml`` over the parity
config, on top of ``configs/fusion-synth.yaml`` (which already has stride
2 and per-level intrinsics): the sparse photometric term
(``rgb.pixel_budget``, here 6144 of the 19200 stride-2 pixels of level 0
at 320x240) and the mesher's latent-reuse gate
(``mesh_reuse_latent_eps: 0.003``).  Both pipelines track, integrate and
mesh the same JAX-rendered frames (320x240, 9 frames, integrate and mesh
every 3 frames, shrunk capacities) with identical weights; the map never
truncates a mesh batch, so the JAX gate is a sound oracle here.

Tolerances as in test_torch_e2e.py and for the same reasons: per-frame
pose within 5 mm and 0.3 deg (the GN early exit may pick a neighbouring
iterate after an f32 rounding difference), ATE and mesh |SDF| within 1 mm
of JAX's, triangle count within 5 %.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fusion_tpu.data.synth import SyntheticSequence
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.system.pipeline import FusionPipeline as JaxPipeline
from nerf_fusion_tpu.utils.config import dict_to_args, parse_config_yaml
from nerf_fusion_tpu.utils.evaluate import ate_rmse as jax_ate
from nerf_fusion_tpu_torch.data.base import FrameData
from nerf_fusion_tpu_torch.data.synth import scene_sdf
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
from nerf_fusion_tpu_torch.utils.evaluate import ate_rmse, mesh_abs_sdf_error

REPO = Path(__file__).resolve().parent.parent
CFG = REPO / "configs" / "fusion-synth.yaml"
N_FRAMES = 9
PIXEL_BUDGET = 6144
REUSE_EPS = 0.003


def _args():
    args = parse_config_yaml(CFG)
    args.single_device = True
    args.integrate_interval = 3
    args.meshing_interval = 3
    args.mesh_reuse_latent_eps = REUSE_EPS
    args.mapping = dict_to_args(args.mapping)
    args.mapping.latent_capacity = 4096
    args.mapping.alloc_capacity = 2048
    args.mapping.points_capacity = 8192
    args.tracking = dict_to_args(args.tracking)
    args.tracking.rgb = {**args.tracking.rgb, "pixel_budget": PIXEL_BUDGET}
    return args


@pytest.fixture(scope="module")
def runs():
    seq = SyntheticSequence(n_frames=N_FRAMES, width=320, height=240)
    frames = [seq.render_frame(i) for i in range(N_FRAMES)]
    ja, ta = _args(), _args()
    jm, ja.model = jax_load_model(REPO / ja.training_hypers, 300)
    tm, ta.model = load_model(REPO / ta.training_hypers, 300)
    jp = JaxPipeline(jm, ja)
    tp = FusionPipeline(tm, ta, "cpu")
    assert tp.tracker.tcfg.rgb_pixel_budget == PIXEL_BUDGET
    assert tp.mesher.reuse_latent_eps == REUSE_EPS
    for i, f in enumerate(frames):
        jp.process_frame(f, i)
        g = FrameData()
        g.rgb, g.depth = torch.tensor(np.asarray(f.rgb)), torch.tensor(np.asarray(f.depth))
        g.calib, g.gt_pose = f.calib, f.gt_pose
        tp.process_frame(g, i)
    jmesh = jp.mesher.extract(ja.resolution, max_std=ja.max_std)
    tmesh = tp.mesher.extract(ta.resolution, max_std=ta.max_std)
    gt = [p.t for p in seq.gt_trajectory]
    return dict(jtraj=jp.trajectory(), ttraj=tp.trajectory(), gt=gt, jmesh=jmesh,
                tmesh=tmesh, seq=seq, reuse=tp.mesher.reuse_stats())


def test_fast_path_poses_match_jax(runs):
    assert len(runs["ttraj"]) == len(runs["jtraj"]) == N_FRAMES
    for j, t in zip(runs["jtraj"], runs["ttraj"]):
        assert np.linalg.norm(j.t - t.t) < 5e-3
        dR = j.q.rotation_matrix.T @ t.q.rotation_matrix
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.3


def test_fast_path_ate_and_mesh_match_jax(runs):
    ate_j = jax_ate(runs["jtraj"], runs["gt"])
    ate_t = ate_rmse([p.t for p in runs["ttraj"]], runs["gt"])
    assert ate_t < 0.02 and abs(ate_t - ate_j) < 1e-3
    jm, tm = runs["jmesh"], runs["tmesh"]
    assert len(jm) > 1000
    assert abs(len(tm) - len(jm)) <= 0.05 * len(jm)
    err_j = float(np.mean(np.abs(np.asarray(runs["seq"].scene_sdf(jm.reshape(-1, 3))))))
    err_t = mesh_abs_sdf_error(tm, scene_sdf)
    assert err_t < 0.02 and abs(err_t - err_j) < 1e-3
    assert runs["reuse"]["updated"] > 0
