"""The check at a size a CPU test run holds: the program passes, and the
control (the reference one precision lower in the program's place) and
each fault the cells can have, planted in the program, come out not
correct.  (One card: no exchange between chips to leave out.)"""

import pytest
import torch

from fusion_bench.tests.tiny import run


def _correct(out):
    return out["failed"] == 0


def test_program_is_correct():
    out = run()
    assert _correct(out), out["checks"]


def test_control_is_not_correct():
    out = run(control=True)
    assert not _correct(out)
    bad = {k for k, (v, lim) in out["checks"].items() if not v <= lim}
    assert {"frontend_point_gap", "frontend_row_mismatch", "map_latent_gap",
            "pose_gap_t_median"} <= bad


def test_posed_control_is_not_correct():
    out = run("room.posed", control=True)
    assert not _correct(out)


def _fault_state_unchanged(monkeypatch):
    """An integration that returns the map as it was."""
    import nerf_fusion_tpu_torch.system.map as map_mod

    def unchanged(state, cfg, encoder, points, *a, **k):
        return state, torch.zeros(cfg.latent_capacity, dtype=torch.bool,
                                  device=points.device)

    monkeypatch.setattr(map_mod, "integrate_keyframe", unchanged)


def _fault_half_batch(monkeypatch):
    """The encoder computes every other row; the rest read 0 (the valid rows
    come first, so a contiguous half would leave out only padding)."""
    from nerf_fusion_tpu_torch.models import encoder as enc_mod

    orig = enc_mod.Encoder.forward

    def half(self, x):
        out = orig(self, x)
        out[1::2] = 0.0
        return out

    monkeypatch.setattr(enc_mod.Encoder, "forward", half)


def _fault_pose_altered(monkeypatch):
    """Each tracked pose moved by 1 mm where the tracker produces it."""
    from nerf_fusion_tpu_torch.system import tracker as tr_mod

    orig = tr_mod.SDFTracker._tracked_epilogue

    def moved(self, pre):
        self.gn.dt.add_(1e-3)
        return orig(self, pre)

    monkeypatch.setattr(tr_mod.SDFTracker, "_tracked_epilogue", moved)


def _fault_mesh_altered(monkeypatch):
    """Each mesh vertex moved by 1 mm where marching cubes produces it."""
    from nerf_fusion_tpu_torch.system import mesher as mesher_mod

    orig = mesher_mod.marching_cubes_sparse

    def moved(*a, **k):
        res = orig(*a, **k)
        return res._replace(vertices=res.vertices + 1e-3)

    monkeypatch.setattr(mesher_mod, "marching_cubes_sparse", moved)


@pytest.mark.parametrize("fault,workload", [
    (_fault_state_unchanged, "room.orbit"), (_fault_half_batch, "room.orbit"),
    (_fault_pose_altered, "room.orbit"), (_fault_mesh_altered, "room.orbit"),
    (_fault_state_unchanged, "room.posed")])
def test_fault_is_not_correct(fault, workload, monkeypatch):
    fault(monkeypatch)
    assert not _correct(run(workload))
