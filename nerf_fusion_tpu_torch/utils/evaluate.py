"""Trajectory + reconstruction evaluation (ATE-RMSE, chamfer).

The reference ships no evaluation code (SURVEY.md §5.5); these are the
BASELINE.json parity metrics, so they are first-class here.
"""

from __future__ import annotations

import numpy as np

from .se3 import Isometry


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment src->dst. Returns (R, t, s)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        s = np.trace(np.diag(D) @ S) / (xs ** 2).sum() * len(src)
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(pred, gt, align: bool = True) -> float:
    """Absolute trajectory error RMSE over translation (metres)."""
    p = np.stack([x.t if isinstance(x, Isometry) else np.asarray(x) for x in pred])
    g = np.stack([x.t if isinstance(x, Isometry) else np.asarray(x) for x in gt])
    assert p.shape == g.shape
    if align and len(p) >= 3:
        R, t, _ = umeyama_alignment(p, g)
        p = p @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p - g) ** 2, axis=1))))


def chamfer_distance(a: np.ndarray, b: np.ndarray, sample: int = 30000,
                     seed: int = 0) -> dict:
    """Symmetric chamfer between two point sets (host-side, cKDTree)."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(seed)
    if len(a) > sample:
        a = a[rng.choice(len(a), sample, replace=False)]
    if len(b) > sample:
        b = b[rng.choice(len(b), sample, replace=False)]
    d_ab = cKDTree(b).query(a)[0]
    d_ba = cKDTree(a).query(b)[0]
    return {
        "chamfer_mean": float(d_ab.mean() + d_ba.mean()) / 2,
        "accuracy": float(d_ab.mean()),
        "completeness": float(d_ba.mean()),
    }


def mesh_abs_sdf_error(vertices: np.ndarray, sdf_fn,
                       sample: int = 200000, device="cpu") -> float:
    """Mean |analytic SDF| at mesh vertices — an exact reconstruction-error
    oracle for scenes rendered from a known SDF.  ``sdf_fn`` is the scene's
    SDF on tensors (e.g. ``sequence.scene_sdf``), evaluated on ``device``.
    """
    import torch

    verts = np.asarray(vertices).reshape(-1, 3)
    if len(verts) == 0:
        return float("nan")
    if len(verts) > sample:
        idx = np.random.default_rng(0).choice(len(verts), sample, False)
        verts = verts[idx]
    v = torch.as_tensor(verts, dtype=torch.float32, device=device)
    return float(torch.mean(torch.abs(sdf_fn(v))))


def sample_mesh_points(tris: np.ndarray, n: int = 50000, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples on a triangle soup (T,3,3)."""
    rng = np.random.RandomState(seed)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    if area.sum() <= 0:
        return tris.reshape(-1, 3)
    idx = rng.choice(len(tris), n, p=area / area.sum())
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return (1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]


def save_tum_trajectory(path, poses, timestamps=None):
    """Write poses as TUM rows: t tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for i, iso in enumerate(poses):
            ts = i if timestamps is None else timestamps[i]
            q = iso.q.q  # (w, x, y, z)
            t = iso.t
            f.write(f"{ts} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def load_tum_trajectory(path):
    rows = np.genfromtxt(path)
    poses = []
    from .se3 import Quaternion
    for r in rows:
        poses.append(Isometry(q=Quaternion(imaginary=r[4:7], real=r[7]), t=r[1:4]))
    return poses
