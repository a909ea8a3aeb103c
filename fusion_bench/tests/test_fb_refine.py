"""The latent refinement's check at a size a CPU test run holds: the
program's refinement passes, and the control (the refinement with TF32
products) and each fault planted in it come out not correct (one card: no
exchange between chips to leave out); the kernel accounting sizes a refined
cadence frame."""

import pytest
import torch

from fusion_bench import harness
from fusion_bench.tests.tiny import TINY

# the tiny cell leaves no voxel eligible (``encoder_count_th`` 1e9); at 20
# the 160x120 frames make some eligible in set-up and in the checked
# cadence; a cloud of 4096 rows keeps the CPU's refinements short
REFINE = {"config": {"fusion": {"mapping": {"encoder_count_th": 20.0,
                                            "points_capacity": 4096}}}}


def run_refine(extra: dict = None, **kw):
    logged = []
    out = harness.run_cell("room-refine.orbit", 2 ** 31 + 977, 3.0, False, device="cpu",
                           overrides=harness.merge(harness.merge(TINY, REFINE), extra or {}),
                           log=logged.append, **kw)
    return out, logged


def _bad(out):
    return {k for k, (v, lim) in out["checks"].items() if not v <= lim}


def test_refined_cell_is_correct_with_eligible_voxels():
    out, logged = run_refine()
    assert out["failed"] == 0, out["checks"]
    assert {"refine_eligible_mismatch", "refine_nll_gap", "refine_latent_gap"} <= set(out["checks"])
    # "check: [set-up ]refinement of frame <f>: <n> eligible, ..."
    counts = [int(line.split(": ")[2].split()[0]) for line in logged
              if " eligible, " in line and "refinement of frame" in line]
    assert len(counts) == 2 and min(counts) > 0, logged


def test_refine_control_is_not_correct():
    out, _ = run_refine(control=True)
    assert {"refine_nll_gap", "refine_latent_gap"} <= _bad(out)


def _core_wrapped(monkeypatch, change):
    """The program's refinement core, its arguments changed by ``change``."""
    import nerf_fusion_tpu_torch.system.refine as refine_mod

    orig = refine_mod.refine_latents_core

    def core(state, cfg, decoder, points, normals, valid, gt_sdf, **k):
        a = change(dict(points=points, normals=normals, gt_sdf=gt_sdf, **k))
        return orig(state, cfg, decoder, a.pop("points"), a.pop("normals"), valid,
                    a.pop("gt_sdf"), **a)

    monkeypatch.setattr(refine_mod, "refine_latents_core", core)


def _fault_step_fewer(monkeypatch):
    """One Adam step fewer than the configuration states."""
    _core_wrapped(monkeypatch, lambda a: dict(a, n_iters=a["n_iters"] - 1))


def _fault_code_term_dropped(monkeypatch):
    """The loss without its L2 code term."""
    _core_wrapped(monkeypatch, lambda a: dict(a, code_reg_lambda=0.0))


def _fault_jitter_redrawn(monkeypatch):
    """The targets from a jitter of their own, not the one handed in."""
    _core_wrapped(monkeypatch, lambda a: dict(a, gt_sdf=0.05 * torch.randn(
        a["gt_sdf"].shape, device=a["gt_sdf"].device)))


def _fault_camera_frame(monkeypatch):
    """The refinement on the frame's camera-frame points, as the JAX map
    does: the world points the map hands in moved back by its pose."""
    from nerf_fusion_tpu_torch.system import map as map_mod
    from nerf_fusion_tpu_torch.system import refine as refine_mod

    orig_integrate, orig_refine = map_mod.SparseVoxelMap.integrate_keyframe, \
        refine_mod.refine_latents
    poses = []

    def integrate(self, points, normals, valid=None, pose=None, **k):
        poses.append(pose)
        return orig_integrate(self, points, normals, valid, pose, **k)

    def refine_latents(state, cfg, decoder, points, normals, valid, generator, **k):
        R, t = poses[-1]
        return orig_refine(state, cfg, decoder, (points - t[None, :]) @ R, normals @ R, valid,
                           generator, **k)

    monkeypatch.setattr(map_mod.SparseVoxelMap, "integrate_keyframe", integrate)
    monkeypatch.setattr(refine_mod, "refine_latents", refine_latents)


def _fault_state_unchanged(monkeypatch):
    """A refinement that hands back the latents it was given."""
    import nerf_fusion_tpu_torch.system.refine as refine_mod

    orig = refine_mod.refine_latents_core

    def unchanged(state, *a, **k):
        return orig(state, *a, **k)._replace(latents=state.latents.clone())

    monkeypatch.setattr(refine_mod, "refine_latents_core", unchanged)


def _fault_half_batch(monkeypatch):
    """Every other corner pair left out, the mean taken over the rest."""
    import nerf_fusion_tpu_torch.system.refine as refine_mod

    orig = refine_mod.refine_targets

    def half(*a, **k):
        t = orig(*a, **k)
        w = t.weight.clone()
        w[1::2] = 0.0
        return t._replace(weight=w, n_samples=torch.clamp_min(w.sum(), 1.0))

    monkeypatch.setattr(refine_mod, "refine_targets", half)


def _fault_latents_altered(monkeypatch):
    """Each refined latent moved by 1e-3 where the refinement produces it."""
    import nerf_fusion_tpu_torch.system.refine as refine_mod

    orig = refine_mod.refine_latents_core

    def moved(*a, **k):
        res = orig(*a, **k)
        return res._replace(latents=res.latents + 1e-3)

    monkeypatch.setattr(refine_mod, "refine_latents_core", moved)


@pytest.mark.parametrize("fault", [_fault_step_fewer, _fault_jitter_redrawn,
                                   _fault_camera_frame, _fault_state_unchanged,
                                   _fault_half_batch, _fault_latents_altered])
def test_refine_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out, _ = run_refine()
    assert _bad(out) & {"refine_nll_gap", "refine_latent_gap", "refine_eligible_mismatch"}, \
        out["checks"]


# At the configuration's code_reg_lambda (1e-2) the code term moves the
# refined latents by less than the program's rounding on the card (the
# median gap reads 1.5e-6 to 2.9e-6 here without it, against a limit of
# 2e-4), so no run can tell its absence; at 1 it shows, which holds that the
# reference refines with the term the configuration states.
STRONG_CODE_TERM = {"config": {"fusion": {"mapping": {"code_reg_lambda": 1.0}},
                               "refine": {"code_reg_lambda": 1.0}}}


def test_code_term_dropped_is_not_correct_where_it_counts(monkeypatch):
    out, _ = run_refine(STRONG_CODE_TERM)
    assert out["failed"] == 0, out["checks"]
    _fault_code_term_dropped(monkeypatch)
    out, _ = run_refine(STRONG_CODE_TERM)
    assert "refine_latent_gap" in _bad(out), out["checks"]


def _refined_ctx(refine_count: int):
    """A traced cadence frame (40) with one extraction of 2 calls and, with
    ``refine_count``, that many refinements of 10 steps over 1234 pairs;
    a tracked frame (41); the window's launches to match."""
    launches = [{"decoder_forward": 2 + 10 * refine_count, "decoder_vjp": 10 * refine_count,
                 "encoder_forward": 1}, {"decoder_forward_grad": 6}]
    return {"config": {"fusion": {"resolution": 4}}, "cadence": 20,
            "frame_ids": list(range(40, 80)),
            "launches": {"decoder_forward": 2 * (2 + 10 * refine_count)},
            "refine": {"n_iters": 10, "count": 2 * refine_count},
            "trace": {"frames": [40, 41], "launches": launches, "valid_points": [21000, 20500],
                      "gn_rows": [8192, 8000], "extractions": [(40, 883, 2)],
                      "refines": [(40, 1234, 10)] * refine_count}}


def test_refined_cadence_frame_is_sized():
    """Each Adam step a decoder_forward and a decoder_vjp call of the pairs
    that count; the mesher's calls as before; model FLOPs the forward and
    the reverse pass of each pair once a step."""
    from fusion_bench.kernels import mlp_flops, mlp_rows
    from fusion_bench.rooflines import model_flops

    rows, unknown = mlp_rows(_refined_ctx(1), 0)
    assert not unknown
    assert rows["decoder_forward"] == [(883 * 512, 2, 1), (1234, 10, 10)]
    assert rows["decoder_vjp"] == [(1234, 10, 10)]
    assert model_flops("decoder_vjp", 1) == 2 * (256 + 128 * 128 + 96 * 128 + 128 * 128 + 128 * 32)
    plain = mlp_flops(_refined_ctx(0), [0])
    assert mlp_flops(_refined_ctx(1), [0]) == plain + 10 * 1234 * (
        model_flops("decoder_forward", 1) + model_flops("decoder_vjp", 1))


def test_unmatched_refine_launches_leave_the_frame_unsized():
    from fusion_bench.kernels import mlp_rows

    ctx = _refined_ctx(1)
    ctx["trace"]["launches"][0]["decoder_vjp"] = 9
    assert mlp_rows(ctx, 0)[1] == {"decoder_vjp"}
    ctx["trace"]["launches"][0]["decoder_forward"] = 11
    assert mlp_rows(ctx, 0)[1] == {"decoder_forward", "decoder_vjp"}


def test_mesher_decodes_read_the_same_with_or_without_refinement():
    from fusion_bench import discovery

    read = discovery.metric_reader("mesher.decodes_per_cadence")
    assert read(_refined_ctx(0)) == read(_refined_ctx(1)) == 2.0


def test_sdf_term_kernels_join_the_tracking_roofline():
    """sdf_rows and sdf_hg: their calls are the frame's launches, their rows
    the frame's gn_rows."""
    from fusion_bench.kernels import kernel_of, traced_work

    assert kernel_of("(anonymous namespace)::sdf_rows_kernel((anonymous namespace)::RowsArgs)") \
        == "sdf_rows"
    assert kernel_of("(anonymous namespace)::sdf_hg_kernel((anonymous namespace)::HgArgs)") \
        == "sdf_hg"
    ctx = _refined_ctx(0)
    ctx["trace"]["launches"][1].update(sdf_rows=6, sdf_hg=6)
    ctx["trace"]["groups"] = []
    ctx["traffic"] = {"camera": {"width": 640, "height": 480}}
    ctx["config"]["fusion"]["tracking"] = {"iter_config": [], "rgb": {}, "sdf": {}}
    work, _ = traced_work(ctx)
    assert work["sdf_rows"] == [({"rows": 8000}, 6, 6)]
    assert work["sdf_hg"] == [({"rows": 8000}, 6, 6)]
