"""The check of the async split (``run_async``: refinement and meshing on the
fusion loop's worker, on map snapshots, merged back at a later cadence) at
a size a CPU test run holds: the program passes, and the control and each
fault planted in the async path come out not correct; a traced run leaves
the map as an untraced one does; the worker's jobs are sized in the frames
that dispatched them.

Two helpers fix the worker's timing, which a run on the CPU leaves to the
threads: ``_prompt`` ends each job before the loop goes on (it is still
collected at the next cadence, as the program collects it), ``_late`` holds
each refinement, and the mesh job queued behind it, until the next
cadence's fusion (``launches.EXCLUSIVE``, as ``tests/test_torch_async.py``
holds it), so that the map merges it after that fusion."""

import hashlib

import pytest
import torch

from fusion_bench import harness
from fusion_bench.tests.test_fb_refine import REFINE
from fusion_bench.tests.tiny import SEED, TINY

# the refinement's cell with ``run_async``, as ``configs/difusion-room-async.json``
# states it; a cloud of 4096 rows and 3 Adam steps keep the CPU's refinements short
WORKLOAD = "room-refine.orbit"
SHORT = {"config": {"fusion": {"run_async": True,
                               "mapping": {"points_capacity": 4096, "optim_n_iters": 3}},
                    "refine": {"n_iters": 3}}}


def run_async(refine: bool = True, seconds: float = 3.0, **kw):
    """The tiny refinement cell with ``run_async``; with ``refine`` voxels
    become eligible for refinement (``test_fb_refine.REFINE``), else every
    integration moves latents."""
    logged = []
    over = harness.merge(harness.merge(TINY, REFINE) if refine else TINY, SHORT)
    out = harness.run_cell(WORKLOAD, SEED, seconds, kw.pop("trace", False), device="cpu",
                           overrides=over, log=logged.append, **kw)
    return out, logged


def _bad(out):
    return {k for k, (v, lim) in out["checks"].items() if not v <= lim}


def _prompt(monkeypatch):
    """Each job ends before ``Worker.submit`` returns."""
    from nerf_fusion_tpu_torch.system import worker as worker_mod

    orig = worker_mod.Worker.submit

    def submit(self, fn, *a, **k):
        fut = orig(self, fn, *a, **k)
        fut.exception()
        return fut

    monkeypatch.setattr(worker_mod.Worker, "submit", submit)


def _late(monkeypatch):
    """The loop's thread takes ``launches.EXCLUSIVE`` (which a worker's job
    waits for) at each refinement's dispatch and gives it back after the
    next fusion, then waits for that refinement: the map merges it after
    the fusion.  The harness's waits give it back first."""
    from nerf_fusion_tpu_torch.ops import launches
    from nerf_fusion_tpu_torch.system import map as map_mod
    from nerf_fusion_tpu_torch.system import refine as refine_mod

    held = []

    def release():
        while held:
            held.pop()
            launches.EXCLUSIVE.release()

    orig_dispatch = refine_mod.AsyncRefiner.dispatch

    def dispatch(self, *a, **k):
        launches.EXCLUSIVE.acquire()
        held.append(self)
        return orig_dispatch(self, *a, **k)

    orig_fuse = map_mod.integrate_keyframe

    def fuse(*a, **k):
        out = orig_fuse(*a, **k)
        refiners = list(held)
        release()
        for r in refiners:
            r.join()
        return out

    orig_wait = harness.Frames.wait

    def wait(self):
        release()
        orig_wait(self)

    monkeypatch.setattr(refine_mod.AsyncRefiner, "dispatch", dispatch)
    monkeypatch.setattr(map_mod, "integrate_keyframe", fuse)
    monkeypatch.setattr(harness.Frames, "wait", wait)
    return release


def _merges(logged):
    """The check's lines on the last cadence's merges."""
    return [m for m in logged if " merges the refinement " in m]


def test_async_cell_is_correct_with_a_merge_replayed(monkeypatch):
    _prompt(monkeypatch)
    out, logged = run_async()
    assert out["failed"] == 0, out["checks"]
    assert {"map_latent_gap", "refine_latent_gap", "mesh_vertex_gap"} <= set(out["checks"])
    assert any(m.endswith("replayed") for m in _merges(logged)), logged
    assert any(m.startswith("check: async refinement dispatched in frame") for m in logged)
    assert any(m.startswith("check: mesh batch of frame") for m in logged)


def test_async_cell_is_correct_with_merges_after_the_fusion(monkeypatch):
    """Each refinement merged after the next cadence's fusion, and each mesh
    job run after it, on their snapshots."""
    _late(monkeypatch)
    out, logged = run_async()
    assert out["failed"] == 0, out["checks"]
    assert any(m.endswith("replayed") for m in _merges(logged)), logged


def test_async_control_is_not_correct(monkeypatch):
    _prompt(monkeypatch)
    out, _ = run_async(control=True)
    assert {"map_latent_gap", "refine_nll_gap", "refine_latent_gap"} <= _bad(out), out["checks"]


def _fault_merge_without_factor(monkeypatch):
    """(a) The de-integration merge without its old_count / cur_count factor."""
    from nerf_fusion_tpu_torch.system import refine as refine_mod

    def merge(state, res, deintegrate):
        latents = state.latents + (res.latents - res.old_latents)
        latents = torch.where(res.refined[:, None], latents, state.latents)
        return state._replace(latents=latents, optimized=state.optimized | res.refined)

    monkeypatch.setattr(refine_mod, "merge_refined", merge)


def test_merge_without_factor_is_not_correct(monkeypatch):
    """(a) In this configuration a refined voxel has reached the encoder's
    count cap, which the fusion no longer updates, so its count at the merge
    is its count at the dispatch, the factor is 1, and the fault changes no
    latent of a run.  The replay holds it where a refined slot was fused
    after the dispatch: the program's merge passes, the fault does not."""
    from fusion_bench.check import map_numbers, replay_cadence
    from nerf_fusion_tpu_torch.system import map as map_mod
    from nerf_fusion_tpu_torch.system import refine as refine_mod

    gen = torch.Generator().manual_seed(5)
    C, L = 8, 29
    old = torch.randn(C, L, generator=gen)
    old_counts = torch.tensor([30.0, 40.0, 50.0, 5.0, 0.0, 60.0, 70.0, 80.0])
    refined = torch.tensor([True, True, False, False, False, True, True, False])
    opt = torch.where(refined[:, None], old + 0.05 * torch.randn(C, L, generator=gen), old)
    # fused since the copy: slots 0, 1 and 3 took 10 observations more
    fused = torch.tensor([True, True, False, True, False, False, False, False])
    counts = old_counts + 10.0 * fused
    latents = torch.where(fused[:, None], old + 0.02 * torch.randn(C, L, generator=gen), old)
    state = map_mod.MapState(indexer=torch.zeros(4, dtype=torch.int32), latents=latents,
                             positions=torch.arange(C, dtype=torch.int32), obs_count=counts,
                             optimized=torch.zeros(C, dtype=torch.bool),
                             n_occupied=torch.tensor(C), overflow=torch.tensor(False))
    res = refine_mod.RefineResult(opt, refined, old, old_counts)
    as_dict = lambda st: {k: getattr(st, k) for k in st._fields}
    ref = replay_cadence(None, as_dict(state), None, [("merge", 20, res, True)], 20,
                         [{"frame_id": 0, "result": res}], None, None, None)
    sound = refine_mod.merge_refined(state, res, deintegrate=True)
    assert map_numbers(as_dict(sound), ref)["map_latent_gap"] < 1e-6
    _fault_merge_without_factor(monkeypatch)
    faulty = refine_mod.merge_refined(state, res, deintegrate=True)
    assert map_numbers(as_dict(faulty), ref)["map_latent_gap"] > 5e-4


def _fault_merge_wrong_slots(monkeypatch):
    """(b) Each merge applied to the slots after the refined ones."""
    from nerf_fusion_tpu_torch.system import refine as refine_mod

    orig = refine_mod.merge_refined

    def shifted(state, res, deintegrate):
        return orig(state, res._replace(refined=torch.roll(res.refined, 1)), deintegrate)

    monkeypatch.setattr(refine_mod, "merge_refined", shifted)


def _fault_merged_in_its_own_cadence(monkeypatch):
    """(c) Sync semantics under ``run_async``: each refinement waited for and
    merged in the cadence that dispatched it."""
    from nerf_fusion_tpu_torch.system import map as map_mod

    orig = map_mod.SparseVoxelMap.integrate_keyframe

    def own_cadence(self, *a, **k):
        out = orig(self, *a, **k)
        if self.refiner is not None and self.refiner.future is not None:
            self.join_refiner()
        return out

    monkeypatch.setattr(map_mod.SparseVoxelMap, "integrate_keyframe", own_cadence)


def _fault_mesh_from_live_state(monkeypatch):
    """(d) The async extraction reads the map as it stands when the worker
    runs it, not the snapshot taken at its dispatch."""
    from nerf_fusion_tpu_torch.system import mesher as mesher_mod

    orig = mesher_mod.Mesher._extract_impl

    def live(self, state, *a, **k):
        return orig(self, self.map.state, *a, **k)

    monkeypatch.setattr(mesher_mod.Mesher, "_extract_impl", live)
    _late(monkeypatch)


def _fault_job_of_the_running_frame(monkeypatch):
    """(e) The refinement refines against the cloud and pose of the frame
    that runs when the worker calls it, not of the frame that dispatched it."""
    from nerf_fusion_tpu_torch.system import pipeline as pipe_mod
    from nerf_fusion_tpu_torch.system import refine as refine_mod

    pipes = []
    orig_init = pipe_mod.FusionPipeline.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        pipes.append(self)

    orig_core = refine_mod.refine_latents_core

    def core(state, cfg, decoder, points, normals, valid, gt_sdf, **k):
        tracker = pipes[-1].tracker
        pts, nrm, mask = tracker.last_processed_pc
        R, t = tracker.all_pd_pose[-1]
        return orig_core(state, cfg, decoder, pts @ R.T + t[None, :], nrm @ R.T, mask, gt_sdf,
                         **k)

    monkeypatch.setattr(pipe_mod.FusionPipeline, "__init__", init)
    monkeypatch.setattr(refine_mod, "refine_latents_core", core)
    _late(monkeypatch)


@pytest.mark.parametrize("fault, refine, caught", [
    (_fault_merge_wrong_slots, True, {"map_latent_gap"}),
    (_fault_merged_in_its_own_cadence, True, {"map_latent_gap"}),
    (_fault_mesh_from_live_state, False, {"mesh_vertex_gap"}),
    (_fault_job_of_the_running_frame, True, {"refine_nll_gap", "refine_latent_gap"}),
])
def test_async_fault_is_not_correct(fault, refine, caught, monkeypatch):
    if fault is _fault_merge_wrong_slots:
        _prompt(monkeypatch)
    fault(monkeypatch)
    out, logged = run_async(refine=refine)
    assert _bad(out) & caught, (out["checks"], [m for m in logged if m.startswith("check")])


def _map_hashes(monkeypatch):
    """A digest of the map state after each integration of the run."""
    from nerf_fusion_tpu_torch.system import map as map_mod

    orig = map_mod.SparseVoxelMap.integrate_keyframe
    digests = []

    def integrate(self, *a, **k):
        out = orig(self, *a, **k)
        h = hashlib.sha256()
        for t in self.state:
            h.update(t.cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        return out

    monkeypatch.setattr(map_mod.SparseVoxelMap, "integrate_keyframe", integrate)
    return digests


def test_traced_run_leaves_the_map_as_an_untraced_one(monkeypatch):
    """The same seed traced and not: the map after each integration that
    both runs made is the same bit for bit (the harness waits for the
    worker's jobs at the trace's edges and collects none), and no roofline
    reads above 100 %."""
    from fusion_bench import discovery

    _prompt(monkeypatch)
    untraced = _map_hashes(monkeypatch)
    run_async()
    monkeypatch.undo()
    _prompt(monkeypatch)
    traced = _map_hashes(monkeypatch)
    out, _ = run_async(trace=True, seconds=10.0)
    ctx = out["ctx"]
    assert ctx["trace"] is not None and ctx["trace"]["async"]
    n = min(len(untraced), len(traced))
    assert n >= 8 and untraced[:n] == traced[:n]
    for name in ("kernels.track_roofline", "kernels.map_roofline", "kernels.refine_roofline"):
        v = discovery.metric_reader(name)(ctx)
        assert v is None or v <= 100.0, (name, v)
    # whole cycles that start with a cadence frame: its jobs run beside the
    # traced frames after it
    frames = ctx["trace"]["frames"]
    assert frames[0] % ctx["cadence"] == 0 and len(frames) % ctx["cadence"] == 0
    assert 0.0 < discovery.metric_reader("map.refines_per_cadence")(ctx) <= 1.0
    assert discovery.metric_reader("mesher.async_lag_frames")(ctx) >= 1


def _async_ctx(extra_launch: int = 0):
    """Traced frames 40-43: frame 40 (a cadence) encodes and dispatches an
    extraction of 2 decoder calls and a refinement of 10 steps over 1234
    pairs, whose launches fall in frames 41 and 42; ``extra_launch`` more
    decoder calls of a job the trace does not hold."""
    launches = [{"encoder_forward": 1}, {"decoder_forward": 7, "decoder_vjp": 5},
                {"decoder_forward": 5 + extra_launch, "decoder_vjp": 5},
                {"decoder_forward_grad": 6}]
    return {"config": {"fusion": {"resolution": 4}}, "cadence": 20,
            "trace": {"frames": [40, 41, 42, 43], "launches": launches, "async": True,
                      "valid_points": [21000, 20500, 20400, 20300],
                      "gn_rows": [8192, 8000, 8000, 8000], "extractions": [(40, 883, 2)],
                      "refines": [(40, 1234, 10)]}}


def test_worker_jobs_are_sized_in_the_frame_that_dispatched_them():
    from fusion_bench.kernels import mlp_flops, mlp_rows
    from fusion_bench.rooflines import model_flops

    ctx = _async_ctx()
    rows, unknown = mlp_rows(ctx, 0)
    assert not unknown
    assert rows["decoder_forward"] == [(883 * 512, 2, 1), (1234, 10, 10)]
    assert rows["decoder_vjp"] == [(1234, 10, 10)]
    assert rows["encoder_forward"] == [(8 * 21000, 1, 1)]
    later, unknown = mlp_rows(ctx, 1)
    assert not unknown and later["decoder_forward"] == [] and later["decoder_vjp"] == []
    assert mlp_flops(ctx, [1, 2]) == 0.0
    assert mlp_flops(ctx, [0]) == 8 * 21000 * model_flops("encoder_forward", 1) \
        + 883 * 512 * model_flops("decoder_forward", 1) \
        + 10 * 1234 * (model_flops("decoder_forward", 1) + model_flops("decoder_vjp", 1))
    # a decoder call of a job the traced frames did not dispatch: unsized
    assert mlp_rows(_async_ctx(extra_launch=1), 0)[1] == {"decoder_forward"}


def test_async_configuration_is_the_refinement_cell_run_async():
    """``configs/difusion-room-async.json``, the deployment these tests run,
    is ``difusion-room-refine.json`` with ``run_async`` on and nothing else
    of the run changed: only its ``source`` and ``aux_device`` note differ."""
    import json

    from fusion_bench import discovery

    load = lambda name: json.loads((discovery.ROOT / "configs" / name).read_text())
    a, r = load("difusion-room-async.json"), load("difusion-room-refine.json")
    assert a["fusion"].pop("run_async") is True and r["fusion"].pop("run_async") is False
    assert set(a) - set(r) == {"aux_device"} and a.pop("source") != r.pop("source")
    a.pop("aux_device")
    assert a == r
