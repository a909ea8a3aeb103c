"""The decoder's ``tp`` layout in two gloo processes on the CPU, against one
process and against the JAX package.

``tools/tp_check.py`` runs the ``ckpt/default`` decoder's eval forward on
256 seeded rows whole and split over two ranks (its own timeout: 180 s;
one intra-op thread a process, as the test processes run side by side).
The sharded forward is within 1e-5 of the whole one and of JAX's
``apply_decoder`` (``tests/test_multichip.py``'s bar), and the ranks split
exactly the tensors that JAX's ``shard_decoder_params`` shards over a
``tp`` axis of 2, each into its rows.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.parallel.mesh import make_mesh, shard_decoder_params
from nerf_fusion_tpu_torch.models import io
from nerf_fusion_tpu_torch.parallel import tp as tpl

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180


def test_tp2_matches_one_process_and_jax(tmp_path):
    out = tmp_path / "tp.npz"
    proc = subprocess.run([sys.executable, "-m", "nerf_fusion_tpu_torch.tools.tp_check",
                           "--tp", "2", "--device", "cpu", "--out", str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = io.load_params(out)
    x = res["x"]
    for k in ("sdf", "std"):
        assert np.abs(res["tp"][k] - res["whole"][k]).max() <= 1e-5
    jm, _ = jax_load_model(REPO / "ckpt/default/hyper.json", 300)
    jsdf, jstd = apply_decoder(jm.decoder_params, jm.decoder_config, jnp.asarray(x))
    assert np.abs(res["tp"]["sdf"] - np.asarray(jsdf)).max() <= 1e-5
    assert np.abs(res["tp"]["std"] - np.asarray(jstd)).max() <= 1e-5
    # the same tensors split as JAX's layout, each into its rows
    mesh = make_mesh(n_devices=2, tp=2)
    sharded = shard_decoder_params(mesh, jm.decoder_params)
    want = {f"{layer}/{k}": v.shape
            for layer, p in sharded.items() for k, v in p.items()
            if tuple(v.sharding.spec)[:1] == ("tp",)}
    got = io.flatten(res["tp"]["split"])
    assert sorted(got) == sorted(want) and "lin1/v" in got and "unc/w" not in got
    for k, shape in want.items():
        assert tuple(got[k]) == (shape[0] // 2,) + tuple(shape[1:]), k
    assert {f"{layer}/{k}" for layer, p in jm.decoder_params.items() for k, v in p.items()
            if tpl.is_split(np.shape(v), 2)} == set(want)
