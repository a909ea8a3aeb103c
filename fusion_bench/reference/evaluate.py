"""Quality of a run against the scene it was rendered from (logged beside
the check, not compared): the trajectory's translation error after a rigid
alignment, and the mean |SDF| of the scene at mesh vertices."""

from __future__ import annotations

import numpy as np
import torch

from .render import scene_sdf


def umeyama(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid (R, t) taking ``src`` (N, 3) onto ``dst``."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    U, _, Vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(pred: np.ndarray, gt: np.ndarray) -> float:
    """RMSE (m) of the translations (N, 3) after alignment."""
    if len(pred) >= 3:
        R, t = umeyama(pred, gt)
        pred = pred @ R.T + t
    return float(np.sqrt(np.mean(np.sum((pred - gt) ** 2, 1))))


def mesh_abs_sdf(vertices: torch.Tensor, primitives) -> float:
    """Mean |scene SDF| (m) at the vertices (..., 3)."""
    v = vertices.reshape(-1, 3).float()
    return float(torch.mean(torch.abs(scene_sdf(v, primitives)))) if len(v) else float("nan")
