"""The port's async mesher and refiner, and its thread-safe launch counters.

* ``extract(extract_async=True)``: None while the extraction is in flight,
  the refreshed cache from the first call after it ended (which starts
  nothing), equal to a sync extraction of the same map.
* Snapshot safety: the worker is held (it waits for ``launches.EXCLUSIVE``,
  which the test holds), another keyframe is integrated into the map in
  place, the worker is released: its triangles, read by ``current_mesh``
  (which waits for the job), equal a sync extraction of the map as it was
  before that integration.
* While a worker runs its job it holds ``launches.EXCLUSIVE``, which a
  graph capture takes, so the capture's launch-counter diff never holds a
  worker's launches; the counters stay exact under 16 threads counting.
* ``run_async`` + ``do_optimize`` through the pipeline at 160x120 on the
  CPU: the mesher's and the refiner's jobs run on the map's one worker
  thread, are joined, and the run meets the e2e gates.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.ops import cuda_build, launches, mlp
from nerf_fusion_tpu_torch.system import map as tmap
from nerf_fusion_tpu_torch.system import mesher as tmesher
from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
from nerf_fusion_tpu_torch.utils import config as exp_util
from nerf_fusion_tpu_torch.utils.config import dict_to_args

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[0.0, 0.0, 0.0], bound_max=[1.0, 1.0, 1.0], voxel_size=0.1,
                prune_min_vox_obs=4, ignore_count_th=16.0, encoder_count_th=600.0,
                latent_capacity=2048, alloc_capacity=512)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(z, seed, n=6000):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(0.3, 0.7, n), rng.uniform(0.3, 0.7, n),
                    np.full(n, z) + rng.randn(n) * 0.002], axis=1).astype(np.float32)
    return pts, np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))


@pytest.fixture(scope="module")
def model():
    return load_model(CKPT, 300)[0]


def _map(model):
    return tmap.SparseVoxelMap(model, dict_to_args(MAP_ARGS), 29, "cpu")


def _copy_map(model, vmap):
    """A second map holding ``vmap``'s state and updated masks."""
    other = _map(model)
    other._assign(tmap.MapState(*(t.clone() for t in vmap.state)))
    other._updated_dev = None if vmap._updated_dev is None else vmap._updated_dev.clone()
    other.updated_slots[:] = vmap.updated_slots
    return other


def _sync_mesh(model, vmap):
    return tmesher.Mesher(_copy_map(model, vmap), max_n_triangles=1 << 15).extract(
        4, max_std=0.3).copy()


def test_extract_async_contract_and_equal_to_sync(model):
    vmap = _map(model)
    vmap.integrate_keyframe(*_plane(0.55, 0))
    want = _sync_mesh(model, vmap)
    mesher = tmesher.Mesher(vmap, max_n_triangles=1 << 15)
    with launches.EXCLUSIVE:                 # the worker waits for it
        assert mesher.extract(4, max_std=0.3, extract_async=True) is None
        assert not mesher._future.done()
        assert mesher.extract(4, max_std=0.3, extract_async=True) is None
    mesher._future.exception(120)
    assert mesher._future.done()
    got = mesher.extract(4, max_std=0.3, extract_async=True)
    assert mesher._future is None               # that call started nothing
    assert len(got) > 50 and np.array_equal(got, want)
    assert (mesher.async_started, mesher.async_returned) == (1, 1)
    # nothing updated since: the next async round re-meshes nothing
    assert mesher.extract(4, max_std=0.3, extract_async=True) is None
    mesher.join_async()
    assert np.array_equal(mesher.current_mesh(), want)


def test_async_worker_reads_its_snapshot(model):
    vmap = _map(model)
    vmap.integrate_keyframe(*_plane(0.55, 0))
    want = _sync_mesh(model, vmap)                   # the map before the next keyframe
    mesher = tmesher.Mesher(vmap, max_n_triangles=1 << 15)
    launches.EXCLUSIVE.acquire()
    try:
        assert mesher.extract(4, max_std=0.3, extract_async=True) is None
        latents_before = vmap.state.latents.clone()
        vmap.integrate_keyframe(*_plane(0.62, 1))    # in place, while the worker waits
        assert not torch.equal(vmap.state.latents, latents_before)
    finally:
        launches.EXCLUSIVE.release()
    got = mesher.current_mesh()                      # waits for the worker's job
    assert mesher._future is None
    assert len(got) > 50 and np.array_equal(got, want)
    # the second keyframe's update was left for the next extraction
    assert vmap._updated_dev is not None and bool(vmap._updated_dev.any())
    left = vmap._updated_dev.numpy().copy()
    assert np.array_equal(vmap.sync_updated(), left) and vmap._updated_dev is None


def test_worker_excludes_captures_and_reraises(model):
    """A capture takes ``launches.EXCLUSIVE``: it cannot start while the
    worker runs its job.  A failing job raises from ``join_async``."""
    vmap = _map(model)
    vmap.integrate_keyframe(*_plane(0.55, 0))
    mesher = tmesher.Mesher(vmap, max_n_triangles=1 << 15)
    inside, release = threading.Event(), threading.Event()
    impl = mesher._extract_impl

    def held(*a, **k):
        inside.set()
        release.wait(60)
        return impl(*a, **k)

    mesher._extract_impl = held
    mesher.extract(4, max_std=0.3, extract_async=True)
    assert inside.wait(60)
    assert not launches.EXCLUSIVE.acquire(blocking=False)
    release.set()
    mesher.join_async()
    assert launches.EXCLUSIVE.acquire(blocking=False)
    launches.EXCLUSIVE.release()

    def broken(*a, **k):
        raise ValueError("boom")

    mesher._extract_impl = broken
    vmap.updated_slots[:] = True
    mesher.extract(4, max_std=0.3, extract_async=True)
    with pytest.raises(RuntimeError):
        mesher.join_async()


def test_launch_counters_exact_under_many_threads():
    """16 threads (more than the cores) count launches of one kernel
    together, with a short switch interval: no count is lost."""
    n, k = 5000, 16
    before = mlp.decoder_forward.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_build.count_launch(mlp.decoder_forward)
                                                    for _ in range(n)]) for _ in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert mlp.decoder_forward.launches == before + k * n
    launches.add({"decoder_forward": -k * n})
    assert mlp.decoder_forward.launches == before


def test_async_pipeline_with_refinement_cpu():
    """160x120, 12 frames, integrate and mesh every 2 frames; the encoder
    threshold lowered to 20 observations so that voxels become eligible
    for refinement within the run."""
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    model, args.model = load_model(REPO / args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.mapping.latent_capacity, args.mapping.points_capacity = 8192, 4096
    args.mapping.encoder_count_th = 20.0
    args.mapping.optim_n_iters = 3
    args.tracking = exp_util.dict_to_args(args.tracking)
    args.integrate_interval = args.meshing_interval = 2
    args.run_async = args.do_optimize = True
    n = 12
    pipe = FusionPipeline(model, args, "cpu")
    res = pipe.run(SyntheticSequence(n_frames=n, width=160, height=120), max_frames=n)
    assert pipe.mesher._future is None and not pipe.map.refiner.busy()
    # the mesher's and the refiner's jobs ran on the map's one worker
    assert pipe.map.refiner.worker is pipe.map.worker
    assert len(pipe.map.worker._pool._threads) == 1
    assert res["async_mesh"]["started"] > 0 and res["async_mesh"]["returned"] > 0
    refs = res["refine"]
    assert refs and all(r["async"] for r in refs) and res["refine_merged"] == len(refs)
    assert any(r["sampled"] > 0 for r in refs)
    assert bool(pipe.map.state.optimized.any())
    assert res["ate_rmse"] < 0.02 and res["mesh_abs_sdf"] < 0.02
    assert res["n_triangles"] > 0 and not res["map"]["overflow"]


def test_refinement_finished_before_dispatch_is_merged(model, monkeypatch):
    """The worker's refinement ends after the merge at the start of the next
    integration and before its dispatch.  The JAX map drops such a result
    (``nerf_fusion_tpu/system/map.py``: it collects before integrating, then
    dispatches over the uncollected job when the refiner is not busy); the
    port merges it before dispatching: its refined rows are in the state
    and ``refine_merged`` counts it."""
    vmap = tmap.SparseVoxelMap(model, dict_to_args({**MAP_ARGS, "encoder_count_th": 20.0,
                                                    "optim_n_iters": 2}), 29, "cpu")
    opt = dict(do_optimize=True, async_optimize=True)
    launches.EXCLUSIVE.acquire()             # the first job waits for it
    held = True
    try:
        vmap.integrate_keyframe(*_plane(0.55, 0))
        vmap.integrate_keyframe(*_plane(0.55, 1), **opt)
        assert vmap.refiner.busy()
        collected = []
        collect = vmap.refiner.collect

        def recording_collect():
            res = collect()
            collected.append(res)
            return res

        monkeypatch.setattr(vmap.refiner, "collect", recording_collect)
        fuse = tmap.integrate_keyframe

        def fuse_then_finish(*a, **k):
            out = fuse(*a, **k)
            nonlocal held
            launches.EXCLUSIVE.release()     # the job runs to its end now
            held = False
            vmap.refiner.join()
            return out

        monkeypatch.setattr(tmap, "integrate_keyframe", fuse_then_finish)
        vmap.integrate_keyframe(*_plane(0.62, 2), **opt)
    finally:
        if held:
            launches.EXCLUSIVE.release()
    # the first collect (before integrating) found the job running; the one
    # before the dispatch merged it
    assert collected[0] is None and collected[1] is not None
    res = collected[1]
    assert vmap.refine_merged == 1 and bool(res.refined.any())
    assert bool(vmap.state.optimized[res.refined].all())
    assert vmap.refiner.future is not None           # the next job was dispatched
    vmap.join_refiner()
    assert vmap.refine_merged == 2
