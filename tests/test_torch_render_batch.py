"""The synthetic renderer's batch mode: on the card an iterated sequence
renders ``RENDER_BATCH`` frames in one pass (``_render_ahead``), and each
frame must be bitwise the single-frame render of its pose, NaN depth at
the same pixels.  Here both run on the CPU, where iteration itself renders
frame by frame."""

import pytest
import torch

from nerf_fusion_tpu_torch.data import synth


def _equal(a, b) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("scene", ["room", "large"])
def test_batch_render_equals_single_frame_render(scene):
    n = synth.RENDER_BATCH + 3          # a full batch and a short one
    seq = synth.SyntheticSequence(n_frames=n, width=40, height=32, scene=scene)
    for i in range(n):
        got, want = seq._render_ahead(i), seq.render_frame(i)
        assert _equal(got.rgb, want.rgb) and _equal(got.depth, want.depth)
        assert got.gt_pose is want.gt_pose and got.calib is want.calib
    assert not seq._ahead and bool(torch.isfinite(got.depth).any())
