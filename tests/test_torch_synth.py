"""Port's synthetic renderer against the JAX package's.

96 sphere-trace steps in f32 on both sides; the step sums round
differently, so a ray grazing an edge may end on the other side of the
5 mm hit test.  Depth agrees to 1e-4 m where both hit; the hit masks on
all but 0.1 % of the pixels.
"""

import jax.numpy as jnp
import numpy as np
import torch

from nerf_fusion_tpu.data import synth as jsynth
from nerf_fusion_tpu_torch.data import synth


def test_render_matches_jax():
    jseq = jsynth.SyntheticSequence(n_frames=20, width=160, height=120)
    tseq = synth.SyntheticSequence(n_frames=20, width=160, height=120)
    assert vars(tseq.calib) == vars(jseq.calib)
    for i in (0, 13):
        jf, tf = jseq.render_frame(i), tseq.render_frame(i)
        assert np.allclose(tf.gt_pose.matrix, jf.gt_pose.matrix, atol=1e-12)
        jd, td = np.asarray(jf.depth), tf.depth.numpy()
        jhit, thit = np.isfinite(jd), np.isfinite(td)
        assert jhit.mean() > 0.9
        assert np.mean(jhit == thit) >= 0.999
        both = jhit & thit
        assert np.abs(jd[both] - td[both]).max() <= 1e-4
        assert np.abs(np.asarray(jf.rgb)[both] - tf.rgb.numpy()[both]).max() <= 1e-3


def test_scene_sdf_matches_jax():
    p = np.random.RandomState(0).uniform(-3, 3, (5000, 3)).astype(np.float32)
    ref = np.asarray(jsynth.scene_sdf(jnp.asarray(p)))
    assert np.abs(synth.scene_sdf(torch.tensor(p)).numpy() - ref).max() <= 1e-6
