"""The port's pipeline around the frame step: ``frames_per_call``, the map's
stable buffers, the entry point's ``first_tq`` and the launch counters.

* ``frames_per_call`` K = 8 against K = 1 on 25 frames at 160x120, as
  ``tests/test_frames_per_call.py`` holds the JAX package's blocks: every
  frame tracked once, the same trajectory (bitwise on the CPU: a block runs
  the same frame step), fewer ``all_pd_pose`` entries than frames.
* The map's tensors keep their storage across ``integrate_keyframe`` and
  ``load`` (the tracker's captured graphs read them) and hold the values of
  the functional ``integrate_keyframe``.
* ``first_tq`` stays in ``sequence_kwargs`` after ``first_iso`` is set from
  it, as the JAX entry point leaves it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fusion_tpu_torch import main as entry
from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import launches
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
from nerf_fusion_tpu_torch.utils import config as exp_util

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the test processes run side by side (pytest-xdist)
    and the small shapes here gain nothing from a thread pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(frames_per_call, n=25):
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    model, args.model = load_model(REPO / args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    # capacities for 160x120 frames (the box filter keeps fewer than 4096
    # of a frame's 4800 points; the GN takes them all)
    args.mapping.latent_capacity, args.mapping.points_capacity = 8192, 4096
    args.tracking = exp_util.dict_to_args(args.tracking)
    args.frames_per_call = frames_per_call
    seq = SyntheticSequence(n_frames=n, width=160, height=120)
    pipe = FusionPipeline(model, args, "cpu")
    return pipe, pipe.run(seq, max_frames=n)


def test_block_tracking_matches_per_frame():
    n = 25
    p1, r1 = _run(1, n)
    p8, r8 = _run(8, n)
    assert p1.tracker.n_tracked == p8.tracker.n_tracked == n
    t1, t8 = p1.trajectory(), p8.trajectory()
    assert len(t1) == len(t8) == n
    for a, b in zip(t1, t8):
        assert np.array_equal(a.t, b.t)
        assert np.array_equal(a.q.rotation_matrix, b.q.rotation_matrix)
    assert r1["ate_rmse"] == r8["ate_rmse"] and r1["n_triangles"] == r8["n_triangles"]
    assert r8["box_filter_drop_frac"] == r1["box_filter_drop_frac"]
    # frames 1-8 and 9-16 are blocks; 17-19 a partial flush, 21-24 the tail
    assert len(p8.tracker.all_pd_pose) == 2 + 2 + 3 + 4 < n
    assert len(p1.tracker.all_pd_pose) == n
    assert p8.tracker.host_reads == p1.tracker.host_reads > 0
    # each drop entry is a tensor of its own, blocks give (K,) vectors
    shapes = sorted({tuple(d.shape) for d in p8.tracker.drop_fracs})
    assert shapes == [(), (8,)]
    ptrs = [d.data_ptr() for d in p1.tracker.drop_fracs]
    assert len(set(ptrs)) == len(ptrs)
    # last_iters: a frame's GN evaluations per group (G,), a block's (K, G)
    frames = [SyntheticSequence(n_frames=n + 2, width=160, height=120).render_frame(k)
              for k in (n, n + 1)]
    per_frame = []
    for f in frames:
        p1.tracker.track_camera(f.rgb, f.depth, f.calib)
        per_frame.append(p1.tracker.last_iters)
    p8.tracker.track_camera_block(torch.stack([torch.as_tensor(f.rgb) for f in frames]),
                                  torch.stack([torch.as_tensor(f.depth) for f in frames]),
                                  frames[0].calib)
    G = len(p8.tracker.tcfg.iter_config)
    assert tuple(per_frame[0].shape) == (G,) and tuple(p8.tracker.last_iters.shape) == (2, G)
    assert torch.equal(p8.tracker.last_iters, torch.stack(per_frame))


def test_run_reports_the_map_and_check_overflow_raises():
    """``run`` reports the voxels allocated and the overflow flag; the map's
    ``check_overflow`` raises once an integration sets the flag."""
    pipe, res = _run(1, n=3)
    assert res["map"]["n_occupied"] == int(pipe.map.state.n_occupied) > 0
    assert res["map"]["overflow"] is False
    pipe.map.check_overflow()
    pipe.map.state.overflow.fill_(True)
    with pytest.raises(RuntimeError, match="latent_capacity"):
        pipe.map.check_overflow()


def test_frames_per_call_must_be_positive():
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    model, args.model = load_model(REPO / args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.tracking = exp_util.dict_to_args(args.tracking)
    args.frames_per_call = 0
    with pytest.raises(ValueError):
        FusionPipeline(model, args, "cpu")


MAP_ARGS = dict(bound_min=[-3.0, -1.0, -3.0], bound_max=[3.0, 3.0, 3.0],
                voxel_size=0.1, prune_min_vox_obs=4, ignore_count_th=4.0,
                encoder_count_th=600.0, latent_capacity=4096, alloc_capacity=2048)


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.0, 0.0, -1.0], [1.0, 1.0, 1.0], (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return torch.from_numpy(pts), torch.from_numpy(nrm)


def test_map_buffers_keep_their_storage(tmp_path):
    model, _ = load_model(REPO / "ckpt/default/hyper.json", 300)
    vmap = tmap.SparseVoxelMap(model, exp_util.dict_to_args(MAP_ARGS), 29, "cpu")
    ptrs = [t.data_ptr() for t in vmap.state]
    ref = tmap.init_state(vmap.cfg, "cpu")
    for seed in (0, 1):
        pts, nrm = _cloud(seed)
        valid = torch.ones(pts.shape[0], dtype=torch.bool)
        vmap.integrate_keyframe(pts, nrm, valid)
        ref, _ = tmap.integrate_keyframe(ref, vmap.cfg, model.encoder, pts, nrm, valid)
        assert [t.data_ptr() for t in vmap.state] == ptrs
        for a, b in zip(vmap.state, ref):
            assert torch.equal(a, b)
    assert int(vmap.state.n_occupied) > 0
    vmap.save(tmp_path / "map.npz")
    other = tmap.SparseVoxelMap(model, exp_util.dict_to_args(MAP_ARGS), 29, "cpu")
    other_ptrs = [t.data_ptr() for t in other.state]
    other.load(tmp_path / "map.npz")
    assert [t.data_ptr() for t in other.state] == other_ptrs
    for a, b in zip(other.state, ref):
        assert torch.equal(a, b)
    small = tmap.SparseVoxelMap(model, exp_util.dict_to_args(
        {**MAP_ARGS, "latent_capacity": 1024}), 29, "cpu")
    with pytest.raises(ValueError):
        small.load(tmp_path / "map.npz")


def test_first_tq_stays_in_sequence_kwargs():
    """``configs/fusion-lr-kt.yaml`` gives ``first_tq``: the entry point sets
    ``first_iso`` from it and leaves it where the reader finds it; a reader
    that takes no ``first_tq`` is built without it."""
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-lr-kt.yaml")
    tq = list(args.sequence_kwargs["first_tq"])
    entry.set_first_iso(args)
    assert args.sequence_kwargs["first_tq"] == tq
    np.testing.assert_allclose(args.first_iso.t, tq[:3])
    np.testing.assert_allclose(args.first_iso.q.rotation_matrix,
                               [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                               atol=1e-12)
    synth = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    synth.sequence_kwargs = {**synth.sequence_kwargs, "n_frames": 3, "width": 32,
                             "height": 24, "first_tq": tq}
    seq = entry.build_sequence(synth, "cpu")
    assert len(seq) == 3 and synth.sequence_kwargs["first_tq"] == tq


def test_launch_counters_move_together():
    """snapshot / diff / add, as the tracker uses them around a capture."""
    before = launches.snapshot()
    assert set(before) == set(launches.NAMES)
    delta = dict.fromkeys(launches.NAMES, 0)
    delta.update(gn_step=3, row_gather_c4=2, decoder_forward_grad=1)
    launches.add(delta, 2)
    assert launches.diff(launches.snapshot(), before) == {k: 2 * v for k, v in delta.items()}
    launches.add(delta, -2)
    assert launches.snapshot() == before
    assert launches.counter_of("void (anonymous namespace)::gn_step_kernel(float const*)") \
        == "gn_step"
    assert launches.counter_of("void at::native::vectorized_elementwise_kernel<4>") is None
