"""The whole slice against the JAX pipeline, and the port's entry point.

Both pipelines track, integrate and mesh the same JAX-rendered frames
(320x240, 9 frames, integrate and mesh every 3 frames, shrunk map
capacities) with identical weights.

Tolerances and why:
  * per-frame pose within 5 mm and 0.3 deg: the GN early exit stops a
    group at the first energy increase, so an f32 rounding difference can
    pick a neighbouring iterate; with the full iteration schedule the
    iterates are near convergence and the two trajectories stay within
    ~3 mm (measured).  The shrunk 4/4/8 schedule of test_tracker.py exits
    before convergence and was measured to drift by up to 11 mm at
    160x120, which is why this test keeps the config's schedule;
  * ATE and mesh |SDF| within 1 mm of the JAX values: both are averages
    over the trajectory / the mesh, so per-frame jitter mostly cancels;
  * triangle count within 5 %: the meshes come from slightly different
    maps (poses differ by millimetres).
"""

import json
import subprocess
import sys
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


def _args():
    args = parse_config_yaml(CFG)
    args.single_device = True
    args.integrate_interval = 3
    args.meshing_interval = 3
    args.mapping = dict_to_args(args.mapping)
    args.mapping.latent_capacity = 4096
    args.mapping.alloc_capacity = 2048
    args.mapping.points_capacity = 8192
    args.tracking = dict_to_args(args.tracking)
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
    for i, f in enumerate(frames):
        jp.process_frame(f, i)
        g = FrameData()
        g.rgb, g.depth = torch.tensor(np.asarray(f.rgb)), torch.tensor(np.asarray(f.depth))
        g.calib, g.gt_pose = f.calib, f.gt_pose
        tp.process_frame(g, i)
    jmesh = jp.mesher.extract(ja.resolution, max_std=ja.max_std)
    tmesh = tp.mesher.extract(ta.resolution, max_std=ta.max_std)
    gt = [p.t for p in seq.gt_trajectory]
    return dict(jtraj=jp.trajectory(), ttraj=tp.trajectory(), gt=gt,
                jmesh=jmesh, tmesh=tmesh, seq=seq)


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
    assert len(jm) > 1000
    assert abs(len(tm) - len(jm)) <= 0.05 * len(jm)
    err_j = float(np.mean(np.abs(np.asarray(runs["seq"].scene_sdf(jm.reshape(-1, 3))))))
    err_t = mesh_abs_sdf_error(tm, scene_sdf)
    assert err_t < 0.02 and abs(err_t - err_j) < 1e-3


def test_entry_point_cpu(tmp_path):
    """``python -m nerf_fusion_tpu_torch.main`` on the CPU at a tiny size
    writes the JAX entry point's four artifacts."""
    out = tmp_path / "out"
    exec_ = ("sequence_kwargs['width']=160;sequence_kwargs['height']=120;"
             "mapping['latent_capacity']=4096;mapping['points_capacity']=8192;"
             "integrate_interval=2;meshing_interval=2")
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_fusion_tpu_torch.main", str(CFG), "--device", "cpu",
         "--max_frames", "3", "--output", str(out), "--exec", exec_],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("trajectory.txt", "mesh.ply", "stats.json", "map.npz"):
        assert (out / name).exists(), name
    stats = json.loads((out / "stats.json").read_text())
    assert stats["n_frames"] == 3 and stats["box_filter_drop_frac"]["max"] == 0.0
    assert len((out / "trajectory.txt").read_text().splitlines()) == 3
    # resume from the saved map: the first extraction re-meshes all of it
    out2 = tmp_path / "out2"
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_fusion_tpu_torch.main", str(CFG), "--device", "cpu",
         "--max_frames", "1", "--output", str(out2), "--exec", exec_,
         "--load_map", str(out / "map.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads((out2 / "stats.json").read_text())["n_triangles"] > 0


def test_entry_point_defaults_to_cuda():
    from nerf_fusion_tpu_torch.main import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
