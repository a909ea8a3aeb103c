"""The port's headless visuals against the JAX package: the ``utils.vis``
builders, the map's preview and debug visuals, and ``--vis`` previews of
the fusion loop.

* The builders give JAX's arrays exactly and ``save_lineset_ply`` JAX's
  bytes (``tests/test_visuals_scale.py``).
* On the same small fused map (a sphere, a 10^3 map of 0.1 m voxels; the
  two packages' latents agree to f32 rounding): ``get_fast_preview_visuals``
  equals JAX's and its PLY is byte-equal; ``get_map_visuals``' sample and
  uncertainty clouds lie at JAX's positions, their sdf and std within 1e-5
  of JAX's decoder on the same voxels (f32 in another order) and so their
  jet colours within 4e-5 (jet's slope is 4), and its mesh has JAX's
  triangle count.  A mesh read leaves the live mesher's updated-voxel
  accumulators as they were and sets no capped slot
  (``tests/test_map.py``).
* ``vis: true`` through the pipeline at 160x120 on the CPU writes the
  previews of ``tests/test_vis_preview.py``; ``vis: false`` writes none.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_fusion_tpu.models.decoder import apply_decoder
from nerf_fusion_tpu.models.io import load_model as jax_load_model
from nerf_fusion_tpu.system.map import SparseVoxelMap as JaxMap
from nerf_fusion_tpu.utils import se3 as jse3
from nerf_fusion_tpu.utils import vis as jvis
from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
from nerf_fusion_tpu_torch.models.io import load_model
from nerf_fusion_tpu_torch.system.map import SparseVoxelMap
from nerf_fusion_tpu_torch.system.mesher import _sample_offsets
from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline
from nerf_fusion_tpu_torch.utils import config as exp_util
from nerf_fusion_tpu_torch.utils import se3 as tse3
from nerf_fusion_tpu_torch.utils import vis as tvis
from nerf_fusion_tpu_torch.utils.config import dict_to_args

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "ckpt/default/hyper.json"
MAP_ARGS = dict(bound_min=[0.0, 0.0, 0.0], bound_max=[1.0, 1.0, 1.0], voxel_size=0.1,
                prune_min_vox_obs=4, ignore_count_th=8.0, encoder_count_th=600.0,
                latent_capacity=2048, alloc_capacity=512)

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test processes run side by side (pytest-xdist)
    and the small shapes here gain nothing from a thread pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_payload(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_vis_builders_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    xyz, t, n = rng.randn(20, 3), rng.rand(20) * 1.4 - 0.2, rng.randn(20, 3)
    _same_payload(tvis.pointcloud(xyz, cfloat=t, normal=n), jvis.pointcloud(xyz, cfloat=t,
                                                                            normal=n))
    _same_payload(tvis.pointcloud(xyz), jvis.pointcloud(xyz))
    assert np.array_equal(tvis.jet(t), jvis.jet(t))
    for c in range(8):
        assert np.array_equal(tvis.color(c), jvis.color(c))
    boxes = [(tvis.wireframe_bbox([0, 0, 0], [1, 2, 3], color_id=4, solid=True),
              jvis.wireframe_bbox([0, 0, 0], [1, 2, 3], color_id=4, solid=True))]
    for m in (0, 1, 5):
        boxes.append((tvis.trajectory(xyz[:m]), jvis.trajectory(xyz[:m])))
    mat = tse3.Isometry.from_twist(np.asarray([0.1, -0.2, 0.3, 0.2, 0.1, -0.3])).matrix
    boxes.append((tvis.camera(tse3.Isometry.from_matrix(mat[:3, :3], mat[:3, 3])),
                  jvis.camera(jse3.Isometry.from_matrix(mat[:3, :3], mat[:3, 3]))))
    boxes.append((tvis.frame(0.5), jvis.frame(0.5)))
    for a, b in boxes:
        _same_payload(a, b)
    merged = tvis.merged_linesets([a for a, _ in boxes if len(a["lines"])])
    _same_payload(merged, jvis.merged_linesets([b for _, b in boxes if len(b["lines"])]))
    tvis.save_lineset_ply(tmp_path / "t.ply", merged)
    jvis.save_lineset_ply(tmp_path / "j.ply", merged)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.fixture(scope="module")
def maps():
    rng = np.random.RandomState(0)
    d = rng.randn(4000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts, nrm = (0.5 + 0.2 * d).astype(np.float32), d.astype(np.float32)
    jm, _ = jax_load_model(CKPT, 300)
    jmap = JaxMap(jm, dict_to_args(MAP_ARGS), latent_dim=29)
    jmap.integrate_keyframe(pts, nrm)
    tm, _ = load_model(CKPT, 300)
    tmap = SparseVoxelMap(tm, dict_to_args(MAP_ARGS), 29, "cpu")
    tmap.integrate_keyframe(pts, nrm)
    return jmap, tmap


def test_preview_visuals_match_jax(maps, tmp_path):
    jmap, tmap = maps
    assert np.array_equal(tmap.bound_max, jmap.bound_max)
    (t,), (j,) = tmap.get_fast_preview_visuals(), jmap.get_fast_preview_visuals()
    _same_payload(t, j)
    assert len(t["points"]) == 8 * (int(tmap.state.n_occupied) + 1)
    tvis.save_lineset_ply(tmp_path / "t.ply", t)
    jvis.save_lineset_ply(tmp_path / "j.ply", j)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_map_visuals_match_jax(maps):
    jmap, tmap = maps
    kw = dict(return_blocks=True, return_samples=True, return_uncertainty=True,
              return_mesh=True, voxel_resolution=4)
    t, j = tmap.get_map_visuals(**kw), jmap.get_map_visuals(**kw)
    _same_payload(t["blocks"][0], j["blocks"][0])
    for key in ("samples", "uncertainty"):
        a, b = t[key][0], j[key][0]
        assert np.array_equal(a["points"], b["points"]) and len(a["points"]) > 1000
        # jet's slope is 4 per unit of the normalised value
        assert np.abs(a["colors"] - b["colors"]).max() <= 4e-5
    assert t["mesh"][0].shape == j["mesh"][0].shape and len(t["mesh"][0]) > 50
    # the clouds' values: sdf and std of decode_samples within 1e-5 of JAX's
    # decoder on JAX's rows (the sample lattice of the same voxels)
    net_in, sdf, std, pos = tmap.decode_samples(4)
    assert np.array_equal(pos, t["samples"][0]["points"])
    st = jmap.state
    slots = np.where((np.asarray(st.positions) >= 0)
                     & (np.asarray(st.obs_count) > jmap.cfg.ignore_count_th))[0]
    offs = _sample_offsets(2)
    jin = np.concatenate([np.repeat(np.asarray(st.latents)[slots], len(offs), axis=0),
                          np.tile(offs, (len(slots), 1))], axis=1)
    assert jin.shape == tuple(net_in.shape)
    j_sdf, j_std = apply_decoder(jmap.model.decoder_params, jmap.model.decoder_config,
                                 jnp.asarray(jin))
    assert np.abs(sdf.numpy() - np.asarray(j_sdf)[:, 0]).max() <= 1e-5
    assert np.abs(std.numpy() - np.asarray(j_std)[:, 0]).max() <= 1e-5
    ref_sdf, ref_std = tmap.model.decoder(net_in)
    assert torch.equal(sdf, ref_sdf[:, 0]) and torch.equal(std, ref_std[:, 0])


def _fused_map():
    tm, _ = load_model(CKPT, 300)
    vmap = SparseVoxelMap(tm, dict_to_args(MAP_ARGS), 29, "cpu")
    rng = np.random.RandomState(0)
    pts = 0.5 + rng.randn(512, 3).astype(np.float32) * 0.03
    vmap.integrate_keyframe(pts, np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (512, 1)))
    return vmap


def test_map_visuals_mesh_preserves_mesher_bookkeeping():
    vmap = _fused_map()             # leaves the device-side accumulator

    def union():
        dev = (vmap._updated_dev.numpy() if vmap._updated_dev is not None
               else np.zeros_like(vmap.updated_slots))
        return vmap.updated_slots | dev

    before = union().copy()
    dev_before = vmap._updated_dev.clone()
    assert before.any()
    out = vmap.get_map_visuals(return_mesh=True, voxel_resolution=4)
    assert len(out["mesh"]) == 1 and len(out["mesh"][0]) > 0
    assert np.array_equal(union(), before)
    assert torch.equal(vmap._updated_dev, dev_before)


def test_map_visuals_mesh_capped_updated_slots_not_set():
    vmap = _fused_map()
    vmap.sync_updated()
    n_before = int(vmap.updated_slots.sum())
    vmap.get_map_visuals(return_mesh=True, voxel_resolution=4)
    assert int(vmap.updated_slots.sum()) == n_before
    assert 0 < n_before < len(vmap.updated_slots)
    assert vmap._updated_dev is None


def _pipeline(vis: bool):
    args = exp_util.parse_config_yaml(REPO / "configs" / "fusion-synth.yaml")
    model, args.model = load_model(REPO / args.training_hypers, args.using_epoch)
    args.mapping = exp_util.dict_to_args(args.mapping)
    args.mapping.latent_capacity, args.mapping.points_capacity = 8192, 4096
    args.tracking = exp_util.dict_to_args(args.tracking)
    args.integrate_interval = args.meshing_interval = 4
    args.max_n_triangles = 1 << 15
    args.vis, args.vis_interval = vis, 4
    return FusionPipeline(model, args, "cpu")


def test_vis_preview_artifacts(tmp_path):
    """9 frames: previews at frames 4 and 8, the trajectory at 4 holding 5
    poses; each preview's time is the ``vis_preview`` stage."""
    out = tmp_path / "out"
    res = _pipeline(True).run(SyntheticSequence(n_frames=9, width=160, height=120),
                              output_dir=out)
    prev = out / "preview"
    meshes = sorted(prev.glob("mesh_*.ply"))
    trajs = sorted(prev.glob("trajectory_*.txt"))
    blocks = sorted(prev.glob("blocks_*.ply"))
    assert [p.name for p in meshes] == ["mesh_00004.ply", "mesh_00008.ply"]
    assert len(trajs) == 2 and len(blocks) == 2
    assert np.loadtxt(trajs[0]).shape == (5, 8) and np.loadtxt(trajs[1]).shape == (9, 8)
    txt = blocks[0].read_text()
    assert "element edge" in txt and len(txt) > 500
    hdr = meshes[1].read_bytes().split(b"end_header")[0].decode()
    assert hdr.startswith("ply\n") and "element vertex" in hdr and "element face" in hdr
    assert res["timing"]["vis_preview"]["count"] == 2
    assert res["ate_rmse"] < 0.03


def test_vis_off_writes_no_preview(tmp_path):
    out = tmp_path / "out"
    res = _pipeline(False).run(SyntheticSequence(n_frames=5, width=160, height=120),
                               output_dir=out)
    assert (out / "mesh.ply").exists() and not (out / "preview").exists()
    assert "vis_preview" not in res["timing"]


def test_entry_vis_flags(tmp_path):
    """Through the entry point: ``--vis 1`` with ``--vis_interval``, and a
    config's own ``vis_interval`` when the flag is not given."""
    from nerf_fusion_tpu_torch import main as entry

    cfg = (REPO / "configs" / "fusion-synth.yaml").read_text().replace(
        'training_hypers: "ckpt/default/hyper.json"', f'training_hypers: "{CKPT}"')
    (tmp_path / "synth.yaml").write_text(cfg)
    (tmp_path / "synth3.yaml").write_text(cfg + "vis_interval: 3\n")
    small = ("sequence_kwargs['width']=160;sequence_kwargs['height']=120;"
             "mapping['latent_capacity']=8192;mapping['points_capacity']=4096")
    for name, flags, frames, want in (("synth.yaml", ["--vis_interval", "2"], 5, [2, 4]),
                                      ("synth3.yaml", [], 7, [3, 6])):
        out = tmp_path / f"out_{name}"
        entry.run([str(tmp_path / name), "--device", "cpu", "--vis", "1", *flags,
                   "--max_frames", str(frames), "--output", str(out), "--exec", small])
        got = sorted(p.name for p in (out / "preview").glob("blocks_*.ply"))
        assert got == [f"blocks_{i:05d}.ply" for i in want]
