"""Offline LIF dataset generation driver.

Counterpart of the JAX package's ``data/generator.py`` (the reference's
``dataset/training/main_generator.py``): per mesh, SDF sampling
(``ops/sdf_sampler``), per-voxel LIF splitting with Chebyshev-radius
neighbourhoods, voxel filters (>= 50 local and surface points, 10-90 %
positive), voxel-local normalisation, an npz payload per LIF, a copy of
each mesh and the ``source.json`` index.

One process draws the meshes from the provider in index order and writes
every file; with ``nproc > 0`` a pool of ``spawn`` workers samples the
meshes and returns their LIFs in that order.  So the output does not
depend on ``nproc``, and with ``nproc: 0`` it is bitwise the JAX
generator's.
"""

from __future__ import annotations

import functools
import json
import logging
import multiprocessing
import shutil
from pathlib import Path

import numpy as np

from ..ops import mesh as M
from ..ops.sdf_sampler import sample_mesh_sdf
from .providers import PROVIDERS


def split_lifs(data_arr: np.ndarray, surface_arr: np.ndarray,
               voxel_size: float, nn_size: float = 2.0,
               min_points: int = 50, pos_ratio_range=(0.1, 0.9)):
    """Split SDF samples into per-voxel LIF chunks (main_generator.py:85-135)."""
    from scipy.spatial import cKDTree

    data_xyz = data_arr[:, :3]
    data_sdf = data_arr[:, 3]
    surf_xyz = surface_arr[:, :3]

    centers = np.unique(np.ceil(data_xyz / voxel_size) - 1, axis=0)
    centers = (centers + 0.5) * voxel_size

    r_lif = voxel_size * nn_size / 2.0
    tree_d = cKDTree(data_xyz)
    tree_s = cKDTree(surf_xyz)
    lif_idx = tree_d.query_ball_point(centers, r_lif, p=np.inf)
    loc_idx = tree_d.query_ball_point(centers, voxel_size * 0.5, p=np.inf)
    srf_idx = tree_s.query_ball_point(centers, r_lif, p=np.inf)

    lifs = []
    for c, li, lo, si in zip(centers, lif_idx, loc_idx, srf_idx):
        if len(lo) < min_points or len(si) < min_points:
            continue
        inner = data_sdf[li]
        pos_ratio = np.count_nonzero(inner > 0) / max(len(li), 1)
        if pos_ratio < pos_ratio_range[0] or pos_ratio > pos_ratio_range[1]:
            continue
        vox_min = c - 0.5 * voxel_size
        vox_max = c + 0.5 * voxel_size
        d = data_arr[li].copy()
        s = surface_arr[si].copy()
        d[:, :3] = (d[:, :3] - c) / voxel_size
        s[:, :3] = (s[:, :3] - c) / voxel_size
        d[:, 3] /= voxel_size
        lifs.append({"min": vox_min.astype(np.float32),
                     "max": vox_max.astype(np.float32),
                     "data": d.astype(np.float32),
                     "surface": s.astype(np.float32)})
    return lifs


def generate_samples(idx_item, args):
    """(idx, provider item) -> (idx, item, LIFs of the mesh); a bad mesh
    (item None) passes through with no LIFs."""
    idx, item = idx_item
    if item is None:
        return idx, None, []
    V, F = item["vertices"], item["faces"]
    mult = item.get("sampler_mult", 1.0)

    rng = np.random.RandomState(idx * 7919 + 13)
    data_arr, surface_arr = sample_mesh_sdf(
        V, F,
        n_samples=int(args.sampler_count * mult * mult),
        var=args.sampler_var,
        perturb_ratio=0.8,
        expand=args.voxel_size * 2.5,
        rng=rng,
        method=int(getattr(args, "sample_method", 1)),
        cameras=item.get("cameras"),
        ortho_half=item.get("ortho_half"))
    data_arr = data_arr * mult
    surface_arr[:, :3] *= mult
    nan_rows = np.any(np.isnan(surface_arr), axis=1)
    surface_arr = surface_arr[~nan_rows]
    return idx, item, split_lifs(data_arr, surface_arr, args.voxel_size,
                                 getattr(args, "nn_size", 2.0))


def _provider_items(provider):
    """(idx, item) in index order; item None for a mesh the provider cannot
    give (counted and skipped, main_generator.py:62-74)."""
    for idx in range(len(provider)):
        try:
            yield idx, provider[idx]
        except Exception as e:  # noqa: BLE001 - any unreadable mesh is skipped, as the reference does
            logging.warning("bad mesh %d: %s", idx, e)
            yield idx, None


def run_generator(args) -> Path:
    provider = PROVIDERS[args.provider](**args.provider_kwargs)
    output = Path(args.output)
    if output.exists():
        logging.info("Removing old dataset at %s", output)
        shutil.rmtree(output)
    (output / "mesh").mkdir(parents=True)
    (output / "payload").mkdir(parents=True)
    with (output / "config.json").open("w") as f:
        json.dump({k: v for k, v in vars(args).items() if k != "exec"}, f,
                  indent=2, default=str)

    work = functools.partial(generate_samples, args=args)
    nproc = int(getattr(args, "nproc", 0) or 0)
    pool = multiprocessing.get_context("spawn").Pool(nproc) if nproc > 0 else None
    results = (pool.imap(work, _provider_items(provider)) if pool is not None
               else map(work, _provider_items(provider)))
    source_list, n_bad, mesh_idx = [], 0, 0
    try:
        for idx, item, lifs in results:
            if item is None:
                n_bad += 1
                continue
            first = len(source_list)
            source_list += [[provider.get_source(idx), mesh_idx, i] for i in range(len(lifs))]
            if lifs:
                logging.info("%d: +%d LIFs (mean %d pts)", mesh_idx, len(lifs),
                             int(np.mean([len(l["data"]) for l in lifs])))
            M.save_obj(output / "mesh" / ("%06d.obj" % mesh_idx), item["vertices"], item["faces"])
            for i, lif in enumerate(lifs):
                np.savez(output / "payload" / ("%08d.npz" % (first + i)), **lif)
            # an index every 25th mesh: a killed run keeps a usable dataset
            if mesh_idx % 25 == 0:
                with (output / "source.json").open("w") as f:
                    json.dump(source_list, f)
            provider.clean(idx)
            mesh_idx += 1
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()

    with (output / "source.json").open("w") as f:
        json.dump(source_list, f, indent=2)
    logging.info("Done with %d bad shapes", n_bad)
    return output
