"""Mesh -> SDF training samples (virtual-scan-free sampler).

Counterpart of the JAX package's ``ops/sdf_sampler.py``, which follows the
reference's ``sampler_cuda/PreprocessMeshCUDA``: (a) oriented surface
samples and (b) query points with signed distances, where the sign comes
from *k-nearest sign voting* against the oriented surfels (unanimous vote
-> signed distance of the nearest surfel; split vote -> sample discarded).

Method 2 (trust mesh normals, area-weighted sampling) by default; method 1
also culls surfels that no virtual camera sees (``visible_surface_points``).
Queries mix near-surface Gaussian perturbations at two scales (sigma,
sigma/5) with uniform samples in the expanded bounding box.

The vote runs in the native grid-hash kNN (``native.knn_sign_vote``).
The JAX package falls back to scipy when that library fails; here the
choice is explicit: ``sign_vote_sdf`` raises if the library cannot be
built, and ``sign_vote_sdf_plain`` is the scipy version the tests hold
it to.
"""

from __future__ import annotations

import numpy as np

from .mesh import sample_surface


def visible_surface_points(pts, nrm, cameras, ortho_half: float,
                           res: int = 256, eps: float = 0.01):
    """Visibility filter by orthographic point-splat z-buffers.

    Method-1 parity: the reference renders the mesh through OpenGL from
    ~100-300 virtual cameras and keeps only seen surfels
    (PreprocessMesh.cu virtual-scan path).  Here each camera splats the
    surfel cloud into an orthographic z-buffer; surfels within ``eps`` of
    the per-pixel minimum depth in ANY view survive.  Back-facing surfels
    (normal pointing away from the camera) never vote.

    :param cameras: list of camera-to-world Isometry (look-at poses).
    :return: (M,) bool visibility mask.
    """
    visible = np.zeros(len(pts), bool)
    for cam in cameras:
        Rcw = cam.q.rotation_matrix.T
        p_cam = (pts - cam.t) @ Rcw.T            # world -> camera
        z = p_cam[:, 2]
        facing = (nrm @ cam.q.rotation_matrix[:, 2]) < 0.0
        u = np.clip(((p_cam[:, 0] / ortho_half) * 0.5 + 0.5) * (res - 1),
                    0, res - 1).astype(np.int64)
        v = np.clip(((p_cam[:, 1] / ortho_half) * 0.5 + 0.5) * (res - 1),
                    0, res - 1).astype(np.int64)
        zbuf = np.full(res * res, np.inf)
        valid = z > 0
        # 3x3 splat footprint: a sparse point set would otherwise leave
        # z-buffer holes that leak hidden surfels into visibility.
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                us = np.clip(u + du, 0, res - 1)
                vs = np.clip(v + dv, 0, res - 1)
                np.minimum.at(zbuf, (vs * res + us)[valid], z[valid])
        visible |= valid & facing & (z <= zbuf[v * res + u] + eps)
    return visible


def sample_mesh_sdf(V, F, n_samples: int, var: float,
                    perturb_ratio: float = 0.8, expand: float = 0.2,
                    n_surface: int = None, k_vote: int = 11, rng=None,
                    method: int = 2, cameras=None, ortho_half: float = None):
    """:return: (data (N,4) xyz+sdf  — NaN-vote rows dropped,
                 surface (M,6) xyz+normal).

    ``method=2`` (default) trusts mesh normals on area-weighted samples;
    ``method=1`` additionally culls surfels invisible from the provided
    virtual cameras (the reference's virtual-scan semantics)."""
    rng = rng or np.random.RandomState(0)
    if n_surface is None:
        n_surface = max(n_samples // 2, 10000)
    surf_pts, surf_nrm = sample_surface(V, F, n_surface, rng)
    if method == 1 and cameras:
        if ortho_half is None:
            ortho_half = float(np.linalg.norm(V.max(0) - V.min(0)) * 0.75)
        vis = visible_surface_points(surf_pts, surf_nrm, cameras, ortho_half)
        if vis.sum() >= 100:
            surf_pts, surf_nrm = surf_pts[vis], surf_nrm[vis]
            n_surface = len(surf_pts)

    n_pert = int(n_samples * perturb_ratio)
    base = surf_pts[rng.randint(0, n_surface, n_pert)]
    sigmas = np.where(rng.rand(n_pert, 1) < 0.5, var, var / 5.0) ** 0.5
    q_pert = base + rng.randn(n_pert, 3) * sigmas
    bb_min = V.min(0) - expand
    bb_max = V.max(0) + expand
    q_unif = rng.rand(n_samples - n_pert, 3) * (bb_max - bb_min) + bb_min
    queries = np.concatenate([q_pert, q_unif]).astype(np.float64)

    sdf, keep = sign_vote_sdf(queries, surf_pts, surf_nrm, k_vote)
    data = np.concatenate([queries[keep], sdf[keep, None]], axis=1).astype(np.float32)
    surface = np.concatenate([surf_pts, surf_nrm], axis=1).astype(np.float32)
    return data, surface


def sign_vote_sdf(queries, surf_pts, surf_nrm, k: int = 11):
    """Signed distance by unanimous kNN sign voting (native library).

    :return: (sdf (N,), keep (N,) bool — False where the vote split).
    """
    from ..native import knn_sign_vote

    return knn_sign_vote(queries, surf_pts, surf_nrm, k)


def sign_vote_sdf_plain(queries, surf_pts, surf_nrm, k: int = 11):
    """``sign_vote_sdf`` through scipy's cKDTree."""
    from scipy.spatial import cKDTree

    tree = cKDTree(surf_pts)
    dist, idx = tree.query(queries, k=k)
    diff = queries[:, None, :] - surf_pts[idx]          # (N, k, 3)
    votes = np.einsum("nkj,nkj->nk", diff, surf_nrm[idx]) > 0
    n_pos = votes.sum(axis=1)
    keep = (n_pos == 0) | (n_pos == k)
    sign = np.where(n_pos == k, 1.0, -1.0)
    return sign * dist[:, 0], keep
