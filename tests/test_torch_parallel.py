"""Data parallelism (``--dp``) in gloo processes on the CPU, against one
process and against the JAX package.

The bar is the JAX package's for its own data parallelism
(``tests/test_multichip.py``): losses within 5e-3 relative and parameters
within 5e-4 after two steps.  The step is the tiny one of
``tests/_train_step_fixture.py`` (B 8, S 32, M 16, no dropout), on a
batch whose halves come from different distributions, so that BatchNorm
statistics taken per rank would miss the bar; the same tool holds the
encoder with a point mask (outputs, input gradients, running statistics),
where a per-rank or an out-of-graph all-reduce of the masked sums misses
it too.  Every subprocess has a timeout.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _train_step_fixture as fixture
from nerf_fusion_tpu.models import io as jio
from nerf_fusion_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nerf_fusion_tpu.trainer.train import make_optimizers, make_train_step
from nerf_fusion_tpu.utils.config import dict_to_args as jdict_to_args
from nerf_fusion_tpu_torch import data_generator, network_trainer
from nerf_fusion_tpu_torch.models import io
from nerf_fusion_tpu_torch.tools import dp_check

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180


def _run(cmd):
    proc = subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _jax_steps(init, sdf, surf, n_steps):
    args = jdict_to_args(dp_check.TINY)
    model = jio.build_model(args, seed=0)
    enc_cfg = JEncoderConfig(args.code_length, model.encoder_config.dims[:-1],
                             bn=args.encoder_specs.get("bn"), mode="train")
    loss_args = jdict_to_args(args.training_loss)
    dec_opt, enc_opt = make_optimizers()
    step = make_train_step(model.decoder_config, enc_cfg, loss_args.types, loss_args,
                           dp_check.S, 1, dec_opt, enc_opt)
    tree = jax.tree_util.tree_map(jnp.asarray, init)
    state = [tree["dec"], tree["enc"], tree["bn"], dec_opt.init(tree["dec"]),
             enc_opt.init(tree["enc"])]
    for _ in range(n_steps):
        *state, logs, _ = step(*state, jnp.asarray(sdf), jnp.asarray(surf),
                               jax.random.PRNGKey(7), jnp.asarray(1), 1e-3, 1e-3)
    dec, enc, bn = jax.tree_util.tree_map(np.asarray, state[:3])
    return {"loss": {k: float(v) for k, v in logs.items()}, "dec": dec, "enc": enc, "bn": bn}


def test_two_ranks_match_one_process_and_jax(tmp_path):
    assert (dp_check.B, dp_check.S, dp_check.M) == (fixture.B, fixture.S, fixture.M)
    out = tmp_path / "dp.npz"
    print(_run(["nerf_fusion_tpu_torch.tools.dp_check", "--dp", "2", "--device", "cpu",
                "--steps", "2", "--out", str(out)]))
    res = io.load_params(out)
    sdf, surf = res["batch"]["sdf"], res["batch"]["surf"]
    # the halves differ: BN statistics of one half are not the batch's
    assert abs(surf[:4, :, :3].mean() - surf[4:, :, :3].mean()) > 0.3
    ref = _jax_steps(res["init"], sdf, surf, 2)
    for run in ("dp", "single"):
        loss_err, param_err = dp_check.compare(res[run], ref)
        assert loss_err <= dp_check.TOL_LOSS and param_err <= dp_check.TOL_PARAM, \
            (run, loss_err, param_err)
    # and the masked encoder, which only the two runs of the port hold
    assert "masked" in res["dp"] and "masked" in res["single"]
    loss_err, param_err = dp_check.compare(res["dp"], res["single"])
    assert loss_err <= dp_check.TOL_LOSS and param_err <= dp_check.TOL_PARAM


@pytest.fixture(scope="module")
def lif_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("dplif") / "ds"
    data_generator.main([str(REPO / "configs/data-simple.yaml"), "--exec",
                         f"provider_kwargs['n_shapes']=2;sampler_count=30000;output='{out}'"])
    return out


def _exec(lif_dir, save_dir, run, dropout=False):
    return (f"train_set[0]['data_path']='{lif_dir}';save_dir='{save_dir}';run_name='{run}';"
            "num_epochs=1;max_steps_per_epoch=3;batch_size=4;samples_per_lif=128;"
            "snapshot_frequency=1;additional_snapshots=[]"
            + ("" if dropout else ";network_specs['dropout']=[]"))


def _records(save):
    return [json.loads(l) for l in (save / "logs" / "scalars.jsonl").read_text().splitlines()]


def test_entry_dp2_matches_one_process_and_rank0_writes(lif_dir, tmp_path):
    """Two ranks first, on a LIF set not packed yet (rank 0 packs it alone),
    then one process."""
    cfg = str(REPO / "configs/train-cnp.yaml")
    assert not (lif_dir / "packed").exists()
    _run(["nerf_fusion_tpu_torch.network_trainer", cfg, "--device", "cpu", "--dp", "2",
          "--exec", _exec(lif_dir, tmp_path, "two")])
    one = network_trainer.main([cfg, "--device", "cpu", "--exec", _exec(lif_dir, tmp_path, "one")])
    two = tmp_path / "two"
    for name in ("hyper.json", "model_1.npz", "encoder_1.npz", "optimizer_1.pt"):
        assert (two / name).exists(), name
    # one writer: the log holds each record once, as the one-process run's
    r1, r2 = _records(one), _records(two)
    assert [(r["tag"], r["step"]) for r in r1] == [(r["tag"], r["step"]) for r in r2]
    for a, b in zip(r1, r2):
        va, vb = a.get("scalar", a.get("train")), b.get("scalar", b.get("train"))
        assert abs(va - vb) <= dp_check.TOL_LOSS * max(1.0, abs(va)), (a, b)
    for part in ("model", "encoder"):
        pa, pb = (io.flatten(io.load_params(d / f"{part}_1.npz")) for d in (one, two))
        assert pa.keys() == pb.keys()
        for k in pa:
            assert np.abs(pa[k] - pb[k]).max() <= dp_check.TOL_PARAM, (part, k)


def test_dp1_is_one_process_bitwise(lif_dir, tmp_path):
    """World size 1 (gloo, in this process) with dropout on: DDP and the
    synchronised BatchNorm change nothing."""
    cfg = str(REPO / "configs/train-cnp.yaml")
    a = network_trainer.main([cfg, "--device", "cpu", "--exec",
                              _exec(lif_dir, tmp_path, "a", dropout=True)])
    b = network_trainer.main([cfg, "--device", "cpu", "--dp", "1", "--exec",
                              _exec(lif_dir, tmp_path, "b", dropout=True)])
    for part in ("model", "encoder"):
        pa, pb = (io.flatten(io.load_params(d / f"{part}_1.npz")) for d in (a, b))
        assert all(np.array_equal(pa[k], pb[k]) for k in pa), part
    assert _records(a) == _records(b)


def test_dp_must_divide_the_batch(lif_dir, tmp_path):
    with pytest.raises(ValueError, match="multiple"):
        network_trainer.main([str(REPO / "configs/train-cnp.yaml"), "--device", "cpu",
                              "--dp", "3", "--exec",
                              _exec(lif_dir, tmp_path, "x") + ";batch_size=8"])
