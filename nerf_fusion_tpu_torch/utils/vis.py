"""Headless visualisation geometry: numpy payloads a viewer or a PLY writer reads.

Counterpart of the JAX package's ``utils/vis.py`` (the reference builds
Open3D geometries; the port, like the JAX package, runs headless): each
builder returns a dict with ``points`` / ``lines`` / ``colors`` (a line set)
or ``points`` / ``colors`` / ``normals`` (a point cloud).  Colour ids index
the reference's palette.  Plain numpy, no device code.
"""

from __future__ import annotations

import numpy as np

_PALETTE = np.array([
    [0.650, 0.650, 0.650],   # 0 grey
    [0.121, 0.466, 0.705],   # 1 blue
    [1.000, 0.498, 0.054],   # 2 orange
    [0.172, 0.627, 0.172],   # 3 green
    [0.839, 0.152, 0.156],   # 4 red
    [0.580, 0.403, 0.741],   # 5 purple
])


def color(color_id: int):
    return _PALETTE[color_id % len(_PALETTE)]


def pointcloud(xyz: np.ndarray, cfloat: np.ndarray = None, normal=None):
    pc = {"type": "pointcloud", "points": np.asarray(xyz, np.float64)}
    if cfloat is not None:
        pc["colors"] = jet(np.asarray(cfloat))
    if normal is not None:
        pc["normals"] = np.asarray(normal, np.float64)
    return pc


def jet(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def wireframe_bbox(extent_min, extent_max, color_id: int = 0, solid: bool = False):
    mn, mx = np.asarray(extent_min, float), np.asarray(extent_max, float)
    corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                        for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    lines = np.array([[0, 1], [0, 2], [0, 4], [1, 3], [1, 5], [2, 3], [2, 6],
                      [3, 7], [4, 5], [4, 6], [5, 7], [6, 7]])
    return {"type": "lineset", "points": corners, "lines": lines,
            "colors": np.tile(color(color_id), (len(lines), 1)),
            "solid": solid}


def trajectory(positions, color_id: int = 1):
    pts = np.asarray(positions, float)
    if len(pts) < 2:
        lines = np.zeros((0, 2), int)
    else:
        lines = np.stack([np.arange(len(pts) - 1), np.arange(1, len(pts))], axis=1)
    return {"type": "lineset", "points": pts, "lines": lines,
            "colors": np.tile(color(color_id), (max(len(lines), 1), 1))}


def camera(iso, scale: float = 0.15, color_id: int = 3):
    """Camera frustum lineset for a camera-to-world Isometry."""
    pts_local = np.array([
        [0.0, 0.0, 0.0],
        [-1.0, -0.75, 2.0], [1.0, -0.75, 2.0],
        [1.0, 0.75, 2.0], [-1.0, 0.75, 2.0],
    ]) * scale
    pts = pts_local @ iso.q.rotation_matrix.T + iso.t
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]])
    return {"type": "lineset", "points": pts, "lines": lines,
            "colors": np.tile(color(color_id), (len(lines), 1))}


def frame(scale: float = 1.0):
    pts = np.array([[0, 0, 0], [scale, 0, 0], [0, scale, 0], [0, 0, scale]], float)
    lines = np.array([[0, 1], [0, 2], [0, 3]])
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    return {"type": "lineset", "points": pts, "lines": lines, "colors": colors}


def merged_linesets(linesets):
    pts, lines, cols = [], [], []
    off = 0
    for ls in linesets:
        pts.append(ls["points"])
        lines.append(ls["lines"] + off)
        cols.append(ls["colors"])
        off += len(ls["points"])
    return {"type": "lineset", "points": np.concatenate(pts),
            "lines": np.concatenate(lines), "colors": np.concatenate(cols)}


def save_lineset_ply(path, ls):
    """Persist a lineset as a PLY with edge elements (viewable in MeshLab)."""
    pts, lines = ls["points"], ls["lines"]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(lines)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for l in lines:
            f.write(f"{l[0]} {l[1]}\n")
