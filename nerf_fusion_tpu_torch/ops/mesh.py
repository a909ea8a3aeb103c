"""Triangle-mesh utilities: procedural primitives, surface sampling, OBJ IO.

Counterpart of the JAX package's ``ops/mesh.py`` (numpy; no Open3D): the
primitives of the simple-shape provider, area-weighted surface sampling
with face normals, and OBJ read / write.
"""

from __future__ import annotations

import numpy as np


# -- primitives (V (n,3) float64, F (m,3) int) ------------------------------

def box_mesh(w: float, h: float, d: float):
    v = np.array([[x, y, z] for x in (0, w) for y in (0, h) for z in (0, d)],
                 dtype=np.float64)
    # 6 faces, outward winding; corner index bits (x<<2 | y<<1 | z)
    quads = [
        (0, 1, 3, 2),   # x = 0, normal -x
        (4, 6, 7, 5),   # x = w, normal +x
        (0, 4, 5, 1),   # y = 0, normal -y
        (2, 3, 7, 6),   # y = h, normal +y
        (0, 2, 6, 4),   # z = 0, normal -z
        (1, 5, 7, 3),   # z = d, normal +z
    ]
    f = []
    for a, b, c, dd in quads:
        f += [(a, b, c), (a, c, dd)]
    return v, np.asarray(f, np.int64)


def sphere_mesh(radius: float = 0.5, n_lat: int = 32, n_lon: int = 64):
    vs = [np.array([0.0, radius, 0.0])]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            vs.append(radius * np.array([np.sin(th) * np.cos(ph), np.cos(th),
                                         np.sin(th) * np.sin(ph)]))
    vs.append(np.array([0.0, -radius, 0.0]))
    V = np.stack(vs)
    F = []
    ring = lambda i, j: 1 + (i - 1) * n_lon + (j % n_lon)
    for j in range(n_lon):  # top cap
        F.append((0, ring(1, j + 1), ring(1, j)))
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            F += [(a, b, d), (a, d, c)]
    last = len(V) - 1
    for j in range(n_lon):  # bottom cap
        F.append((last, ring(n_lat - 1, j), ring(n_lat - 1, j + 1)))
    return V, np.asarray(F, np.int64)


def cylinder_mesh(radius: float = 0.5, height: float = 1.0, n_seg: int = 64):
    top, bot = height / 2, -height / 2
    V = [np.array([0.0, 0.0, top]), np.array([0.0, 0.0, bot])]
    for j in range(n_seg):
        a = 2 * np.pi * j / n_seg
        V.append(np.array([radius * np.cos(a), radius * np.sin(a), top]))
    for j in range(n_seg):
        a = 2 * np.pi * j / n_seg
        V.append(np.array([radius * np.cos(a), radius * np.sin(a), bot]))
    V = np.stack(V)
    F = []
    t = lambda j: 2 + (j % n_seg)
    b = lambda j: 2 + n_seg + (j % n_seg)
    for j in range(n_seg):
        F.append((0, t(j), t(j + 1)))              # top cap (+z)
        F.append((1, b(j + 1), b(j)))              # bottom cap (-z)
        F += [(t(j), b(j), b(j + 1)), (t(j), b(j + 1), t(j + 1))]  # side
    return V, np.asarray(F, np.int64)


# -- transforms & sampling ---------------------------------------------------

def transform_mesh(V, mat4):
    return V @ mat4[:3, :3].T + mat4[:3, 3]


def face_normals(V, F):
    v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    l = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(l, 1e-12), 0.5 * l[:, 0]


def sample_surface(V, F, n: int, rng=None):
    """Area-weighted surface samples with face normals -> (pts (n,3), nrm (n,3))."""
    rng = rng or np.random.RandomState(0)
    nrm, area = face_normals(V, F)
    p = area / area.sum()
    fi = rng.choice(len(F), n, p=p)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    v0, v1, v2 = V[F[fi, 0]], V[F[fi, 1]], V[F[fi, 2]]
    pts = (1 - r1) * v0 + r1 * (1 - r2) * v1 + r1 * r2 * v2
    return pts, nrm[fi]


# -- OBJ IO ------------------------------------------------------------------

def save_obj(path, V, F):
    with open(path, "w") as f:
        for v in V:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in F:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def load_obj(path):
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    fs.append((idx[0], idx[k], idx[k + 1]))
    return np.asarray(vs, np.float64), np.asarray(fs, np.int64)
