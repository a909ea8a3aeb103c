"""SE(3)/SO(3) math: host-side numpy ``Isometry`` + quaternion utilities.

Semantics-compatible with the reference pose library (SURVEY.md §2.6;
reference: utils/motion_util.py): twists are ``xi = [rho, phi]`` with
``t = J_l(phi) @ rho`` in ``from_twist``/``log``, ``dot`` composes
left-to-right, ``@`` transforms (N,3) point arrays, and ``to_gl_camera``
post-multiplies a 180-degree rotation about X.

Provenance: the Quaternion half of this file is an original numpy
implementation (it replaces the reference's pyquaternion dependency) built
from standard Lie-group formulas.  The ``Isometry`` API — its method set,
structure, and several method bodies (``from_matrix``, ``from_twist``,
``look_at``, ``continuous_repr``/``from_continuous_repr``, ``full_repr``,
``project_orthogonal``) — is ported from the reference's
``utils/motion_util.py:155-299``: downstream code (config ``first_tq``,
TUM trajectory IO, GL-camera conversions) mandates identical semantics,
so those bodies intentionally track the reference formula-for-formula.

The device-side (tensor) counterparts live in ``utils.se3_torch``.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) — minimal numpy implementation.
# ---------------------------------------------------------------------------


class Quaternion:
    """Unit quaternion with the small API surface the framework needs."""

    __slots__ = ("q",)

    def __init__(self, array=None, *, axis=None, degrees=None, radians=None,
                 matrix=None, imaginary=None, real=None):
        if matrix is not None:
            self.q = _quat_from_matrix(np.asarray(matrix, dtype=np.float64))
        elif axis is not None:
            axis = np.asarray(axis, dtype=np.float64)
            axis = axis / np.linalg.norm(axis)
            if degrees is not None:
                radians = np.deg2rad(degrees)
            half = 0.5 * float(radians)
            self.q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        elif imaginary is not None:
            self.q = np.concatenate([[float(real)], np.asarray(imaginary, dtype=np.float64)])
        elif array is not None:
            self.q = np.asarray(array, dtype=np.float64).copy()
        else:
            self.q = np.array([1.0, 0.0, 0.0, 0.0])

    # -- accessors ----------------------------------------------------------
    @property
    def w(self):
        return self.q[0]

    @property
    def elements(self):
        return self.q

    @property
    def rotation_matrix(self):
        w, x, y, z = self.q / np.linalg.norm(self.q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])

    @property
    def transformation_matrix(self):
        mat = np.eye(4)
        mat[:3, :3] = self.rotation_matrix
        return mat

    @property
    def inverse(self):
        w, x, y, z = self.q
        n = np.dot(self.q, self.q)
        return Quaternion(array=np.array([w, -x, -y, -z]) / n)

    def normalised(self):
        return Quaternion(array=self.q / np.linalg.norm(self.q))

    def rotate(self, v):
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion(array=np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]))

    def __repr__(self):
        return f"Quaternion({self.q})"

    @staticmethod
    def random(rng: np.random.RandomState = None):
        # Shoemake's uniform random rotation.  Pass `rng` for determinism
        # independent of the global numpy state (data generation must not
        # depend on caller import/collection order).
        u1, u2, u3 = (rng or np.random).random(3)
        return Quaternion(array=np.array([
            np.sqrt(1 - u1) * np.sin(2 * np.pi * u2),
            np.sqrt(1 - u1) * np.cos(2 * np.pi * u2),
            np.sqrt(u1) * np.sin(2 * np.pi * u3),
            np.sqrt(u1) * np.cos(2 * np.pi * u3),
        ]))

    @staticmethod
    def slerp(q0: "Quaternion", q1: "Quaternion", amount: float) -> "Quaternion":
        a = q0.q / np.linalg.norm(q0.q)
        b = q1.q / np.linalg.norm(q1.q)
        d = float(np.dot(a, b))
        if d < 0.0:
            b, d = -b, -d
        if d > 0.9995:
            out = a + amount * (b - a)
            return Quaternion(array=out / np.linalg.norm(out))
        theta0 = np.arccos(np.clip(d, -1.0, 1.0))
        theta = theta0 * amount
        s0 = np.cos(theta) - d * np.sin(theta) / np.sin(theta0)
        s1 = np.sin(theta) / np.sin(theta0)
        return Quaternion(array=s0 * a + s1 * b)


def _quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3x3 or 4x4) -> quaternion (w,x,y,z), Shepperd's method."""
    m = m[:3, :3]
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# so(3)/se(3) numpy helpers.
# ---------------------------------------------------------------------------


def so3_wedge(phi: np.ndarray) -> np.ndarray:
    x, y, z = phi
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def so3_vee(Phi: np.ndarray) -> np.ndarray:
    return np.array([Phi[2, 1], Phi[0, 2], Phi[1, 0]])


def so3_exp(phi: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(phi)
    if np.isclose(angle, 0.0):
        return np.eye(3) + so3_wedge(phi)
    axis = phi / angle
    s, c = np.sin(angle), np.cos(angle)
    return c * np.eye(3) + (1 - c) * np.outer(axis, axis) + s * so3_wedge(axis)


def so3_log(matrix: np.ndarray) -> np.ndarray:
    cos_angle = np.clip(0.5 * np.trace(matrix) - 0.5, -1.0, 1.0)
    angle = np.arccos(cos_angle)
    if np.isclose(angle, 0.0):
        return so3_vee(matrix - np.eye(3))
    return so3_vee((0.5 * angle / np.sin(angle)) * (matrix - matrix.T))


def so3_left_jacobian(phi: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(phi)
    if np.isclose(angle, 0.0):
        return np.eye(3) + 0.5 * so3_wedge(phi)
    axis = phi / angle
    s, c = np.sin(angle), np.cos(angle)
    return ((s / angle) * np.eye(3)
            + (1 - s / angle) * np.outer(axis, axis)
            + ((1 - c) / angle) * so3_wedge(axis))


def so3_inv_left_jacobian(phi: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(phi)
    if np.isclose(angle, 0.0):
        return np.eye(3) - 0.5 * so3_wedge(phi)
    axis = phi / angle
    half = 0.5 * angle
    cot = 1.0 / np.tan(half)
    return (half * cot * np.eye(3)
            + (1 - half * cot) * np.outer(axis, axis)
            - half * so3_wedge(axis))


def project_orthogonal(rot: np.ndarray) -> np.ndarray:
    u, _, vh = np.linalg.svd(rot, full_matrices=True)
    out = u @ vh
    if np.linalg.det(out) < 0:
        u[:, 2] = -u[:, 2]
        out = u @ vh
    return out


# ---------------------------------------------------------------------------
# Isometry (rigid transform).
# ---------------------------------------------------------------------------


class Isometry:
    GL_POST_MULT = Quaternion(axis=[1.0, 0.0, 0.0], degrees=180.0)

    def __init__(self, q: Quaternion = None, t=None):
        if q is None:
            q = Quaternion()
        if t is None:
            t = np.zeros(3)
        t = np.asarray(t, dtype=np.float64)
        assert t.shape == (3,)
        self.q = q
        self.t = t

    def __repr__(self):
        return f"Isometry: t = {self.t}, q = {self.q}"

    @property
    def rotation(self) -> "Isometry":
        return Isometry(q=self.q)

    @property
    def matrix(self) -> np.ndarray:
        mat = self.q.transformation_matrix
        mat[0:3, 3] = self.t
        return mat

    @staticmethod
    def from_matrix(mat: np.ndarray, t_component=None, ortho=False) -> "Isometry":
        if t_component is None:
            assert mat.shape == (4, 4)
            rot = mat[:3, :3]
            if ortho:
                rot = project_orthogonal(rot)
            return Isometry(q=Quaternion(matrix=rot), t=mat[:3, 3])
        assert mat.shape == (3, 3)
        if ortho:
            mat = project_orthogonal(mat)
        return Isometry(q=Quaternion(matrix=mat), t=np.asarray(t_component))

    @staticmethod
    def from_twist(xi: np.ndarray) -> "Isometry":
        rho, phi = np.asarray(xi[:3]), np.asarray(xi[3:6])
        iso = Isometry(q=Quaternion(matrix=so3_exp(phi)))
        iso.t = so3_left_jacobian(phi) @ rho
        return iso

    def log(self) -> np.ndarray:
        phi = so3_log(self.q.rotation_matrix)
        rho = so3_inv_left_jacobian(phi) @ self.t
        return np.hstack([rho, phi])

    @staticmethod
    def random(rng: np.random.RandomState = None) -> "Isometry":
        return Isometry(q=Quaternion.random(rng),
                        t=(rng or np.random).random(3))

    def inv(self) -> "Isometry":
        qinv = self.q.inverse
        return Isometry(q=qinv, t=-(qinv.rotate(self.t)))

    def dot(self, right: "Isometry") -> "Isometry":
        return Isometry(q=self.q * right.q, t=self.q.rotate(right.t) + self.t)

    def to_gl_camera(self) -> "Isometry":
        return Isometry(q=self.q * self.GL_POST_MULT, t=self.t)

    @staticmethod
    def look_at(source: np.ndarray, target: np.ndarray, up: np.ndarray = None) -> "Isometry":
        z_dir = target - source
        z_dir = z_dir / np.linalg.norm(z_dir)
        if up is None:
            up = np.asarray([0.0, 1.0, 0.0])
            if np.linalg.norm(np.cross(z_dir, up)) < 1e-6:
                up = np.asarray([1.0, 0.0, 0.0])
        else:
            up = up / np.linalg.norm(up)
        x_dir = np.cross(z_dir, up)
        x_dir = x_dir / np.linalg.norm(x_dir)
        y_dir = np.cross(z_dir, x_dir)
        return Isometry(q=Quaternion(matrix=np.column_stack([x_dir, y_dir, z_dir])), t=source)

    @staticmethod
    def interpolate(source: "Isometry", target: "Isometry", alpha: float) -> "Isometry":
        return Isometry(q=Quaternion.slerp(source.q, target.q, alpha),
                        t=source.t * (1 - alpha) + target.t * alpha)

    def adjoint_matrix(self) -> np.ndarray:
        """6x6 adjoint mapping twists between frames (motion_util.py:300-307)."""
        R = self.q.rotation_matrix
        adj = np.zeros((6, 6))
        adj[0:3, 0:3] = R
        adj[3:6, 3:6] = R
        adj[0:3, 3:6] = so3_wedge(self.t) @ R
        return adj

    @property
    def continuous_repr(self) -> np.ndarray:
        """9-dof (6-dof rotation + translation) continuous representation."""
        rot = self.q.rotation_matrix[:, 0:2].T.flatten()
        return np.concatenate([rot, self.t])

    @staticmethod
    def from_continuous_repr(rep, gs: bool = True) -> "Isometry":
        rep = np.asarray(rep, dtype=np.float64)
        assert rep.shape == (9,)
        col1, col2 = rep[0:3].copy(), rep[3:6].copy()
        if gs:  # Gram-Schmidt
            col1 /= np.linalg.norm(col1)
            col2 = col2 - np.dot(col1, col2) * col1
            col2 /= np.linalg.norm(col2)
        col3 = np.cross(col1, col2)
        return Isometry(q=Quaternion(matrix=np.column_stack([col1, col2, col3])),
                        t=rep[6:9])

    @property
    def full_repr(self) -> np.ndarray:
        return np.concatenate([self.q.rotation_matrix.T.flatten(), self.t])

    @staticmethod
    def from_full_repr(rep, ortho: bool = False) -> "Isometry":
        rep = np.asarray(rep, dtype=np.float64)
        rot = rep[0:9].reshape(3, 3).T
        if ortho:
            rot = project_orthogonal(rot)
        return Isometry(q=Quaternion(matrix=rot), t=rep[9:12])

    def __matmul__(self, other):
        if isinstance(other, Isometry):
            return self.dot(other)
        other = np.asarray(other)
        if other.ndim == 1:
            return self.q.rotate(other) + self.t
        return other @ self.q.rotation_matrix.T + self.t[np.newaxis, :]
