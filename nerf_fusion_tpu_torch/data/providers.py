"""Mesh providers for LIF data generation.

Counterpart of the JAX package's ``data/providers.py`` (the reference's
``dataset/training/{simple_shape,shapenet_model}.py`` without Open3D):
primitives are generated procedurally (``ops/mesh.py``) and ShapeNet OBJs
are parsed directly.  Providers return in-memory meshes, with virtual
cameras for the simple shapes (the sampler's method 1).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..ops import mesh as M
from ..utils.se3 import Isometry


class SimpleShapeGenerator:
    """Random cubes/spheres/cylinders in ~[-1, 1], random pose.

    (simple_shape.py:8-117 semantics: per-axis scales in [0.1, 1.5],
    translation in [-0.5, 0.5].)
    """

    def __init__(self, n_shapes: int, seed: int = 4):
        self.n_shapes = n_shapes
        self.rng = np.random.RandomState(seed)
        self.data_sources = self.rng.randint(0, 3, size=(n_shapes,))
        self.sampler_mult = 1.0

    def __len__(self):
        return self.n_shapes

    def get_source(self, idx):
        return ["Cube", "Sphere", "Cylinder"][self.data_sources[idx]]

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.rng.randint(1 << 31) ^ idx)
        kind = self.data_sources[idx]
        s = lambda: rng.uniform(0.1, 1.5)
        if kind == 0:
            V, F = M.box_mesh(s(), s(), s())
            V = V - V.mean(0)
        elif kind == 1:
            V, F = M.sphere_mesh(0.5)
            V = V * np.array([s(), s(), s()])
        else:
            V, F = M.cylinder_mesh(0.5, 1.0)
            V = V * np.array([s(), s(), s()])
        tf = Isometry.random(rng)
        tf.t = rng.uniform(-0.5, 0.5, size=3)
        V = M.transform_mesh(V, tf.matrix)
        cams, ortho = self._virtual_cameras(V)
        return {"vertices": V, "faces": F, "name": self.get_source(idx),
                "sampler_mult": 1.0, "cameras": cams, "ortho_half": ortho}

    @staticmethod
    def _virtual_cameras(V, n: int = 100):
        """Fibonacci-sphere look-at cameras around the mesh
        (simple_shape.py:31-41,96-107 semantics)."""
        phi = np.pi * (3.0 - np.sqrt(5.0))
        pts = []
        for i in range(n):
            y = 1 - (i / float(n - 1)) * 2
            r = np.sqrt(max(1 - y * y, 0.0))
            pts.append((np.cos(phi * i) * r, y, np.sin(phi * i) * r))
        pts = np.asarray(pts)
        center = (V.max(0) + V.min(0)) / 2
        scale = max(float(np.linalg.norm(V.max(0) - center)) * 1.1, 0.8)
        cams = [Isometry.look_at(p * scale * 2.2 + center, center) for p in pts]
        return cams, scale * 1.6

    def clean(self, idx):
        pass


class ShapeNetGenerator:
    """ShapeNetCore.v2 provider (shapenet_model.py:11-78 semantics)."""

    def __init__(self, shapenet_path, categories, shapes_per_category, scale=None,
                 valid_list: str = None, seed: int = 4):
        self.base = Path(shapenet_path)
        self.items = []
        rng = np.random.RandomState(seed)
        valid = None
        if valid_list and Path(valid_list).exists():
            with open(valid_list) as f:
                valid = set(json.load(f))
        for ci, cat in enumerate(categories):
            cdir = self.base / cat
            if not cdir.exists():
                continue
            shapes = sorted(p.name for p in cdir.iterdir() if p.is_dir())
            if valid is not None:
                shapes = [sh for sh in shapes if f"{cat}/{sh}" in valid]
            rng.shuffle(shapes)
            mult = scale[ci] if scale else 1.0
            for sh in shapes[:shapes_per_category[ci]]:
                self.items.append((cat, sh, mult))

    def __len__(self):
        return len(self.items)

    def get_source(self, idx):
        cat, sh, _ = self.items[idx]
        return f"{cat}/{sh}"

    def __getitem__(self, idx):
        cat, sh, mult = self.items[idx]
        obj = self.base / cat / sh / "models" / "model_normalized.obj"
        V, F = M.load_obj(obj)
        return {"vertices": V, "faces": F, "name": self.get_source(idx),
                "sampler_mult": mult}

    def clean(self, idx):
        pass


PROVIDERS = {
    "simple_shape": SimpleShapeGenerator,
    "shapenet_model": ShapeNetGenerator,
}
