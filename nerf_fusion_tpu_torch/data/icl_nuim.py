"""ICL-NUIM RGB-D sequence reader.

Counterpart of the JAX package's ``data/icl_nuim.py``: the ``rgb/%d.png`` +
``depth/%d.png`` layout, the fixed intrinsics (481.2, 480, 319.5, 239.5,
depth scale 5000), TUM-freiburg ground truth with the Y-flip and
180-degree-Z canonicalisation, and the ``first_tq`` starting pose.  Frames
come back on the host at sensor width (uint8 rgb, uint16 depth counts);
the frontend converts them on the device.  PNGs are decoded with OpenCV.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..utils.se3 import Isometry, Quaternion
from .base import FrameData, FrameIntrinsic, RGBDSequence


def imread(path: Path, flags=None) -> np.ndarray:
    """OpenCV's ``imread`` (``flags`` default: 8-bit BGR), raising where the
    file is missing or does not decode, and naming OpenCV where it is not
    installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading RGB-D frames needs OpenCV (the cv2 package)") from e
    img = cv2.imread(str(path), cv2.IMREAD_COLOR if flags is None else flags)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return img


def read_rgb(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    return np.ascontiguousarray(imread(path)[..., ::-1])


def read_depth16(path: Path) -> np.ndarray:
    """(H, W) uint16 depth counts."""
    import cv2

    return np.ascontiguousarray(imread(path, cv2.IMREAD_UNCHANGED).astype(np.uint16))


class ICLNUIMSequence(RGBDSequence):
    CALIB = [481.20, 480.0, 319.50, 239.50, 5000.0]

    def __init__(self, path: str, start_frame: int = 0, end_frame: int = -1,
                 first_tq: list = None, load_gt: bool = False, mesh_gt: str = None):
        super().__init__()
        self.path = Path(path)
        self.color_names = sorted(
            [f"rgb/{t}" for t in os.listdir(self.path / "rgb")],
            key=lambda t: int(t[4:].split(".")[0]))
        self.depth_names = [f"depth/{t}.png" for t in range(len(self.color_names))]

        if first_tq is not None:
            self.first_iso = Isometry(q=Quaternion(array=first_tq[3:]),
                                      t=np.array(first_tq[:3]))
        else:
            self.first_iso = Isometry(q=Quaternion(array=[0.0, -1.0, 0.0, 0.0]))

        if end_frame == -1:
            end_frame = len(self.color_names)
        self.color_names = self.color_names[start_frame:end_frame]
        self.depth_names = self.depth_names[start_frame:end_frame]

        if load_gt:
            cands = list(self.path.glob("*.freiburg")) + \
                list(self.path.glob("groundtruth.txt"))
            self.gt_trajectory = self._parse_traj_file(cands[0])
            self.gt_trajectory = self.gt_trajectory[start_frame:end_frame]
            change = self.first_iso.dot(self.gt_trajectory[0].inv())
            self.gt_trajectory = [change.dot(t) for t in self.gt_trajectory]
        else:
            self.gt_trajectory = None

    @staticmethod
    def _parse_traj_file(traj_path):
        """TUM rows (id, t, qxyzw) -> canonicalised Isometry list: the
        second axis mirrored, then a 180-degree Z rotation; frame 0 takes
        row 1's pose (the reference parser's quirk)."""
        camera_ext = {}
        data = np.genfromtxt(traj_path)
        cano = Isometry(q=Quaternion(axis=[0.0, 0.0, 1.0], degrees=180.0))
        for row in data:
            R = Quaternion(imaginary=row[4:7], real=row[7]).rotation_matrix
            t = row[1:4].copy()
            R[1] = -R[1]
            R[:, 1] = -R[:, 1]
            t[1] = -t[1]
            iso = Isometry(q=Quaternion(matrix=R), t=t)
            camera_ext[row[0]] = cano.dot(iso)
        camera_ext[0] = camera_ext.get(1, next(iter(camera_ext.values())))
        return [camera_ext[t] for t in range(len(camera_ext))]

    def __len__(self):
        return len(self.color_names)

    def load_frame(self, idx: int) -> FrameData:
        """Random-access decode; touches no reader state, so a
        ``PrefetchSequence`` may call it from several threads."""
        frame = FrameData()
        frame.gt_pose = (self.gt_trajectory[idx]
                         if self.gt_trajectory is not None else None)
        frame.calib = FrameIntrinsic(*self.CALIB)
        frame.depth = read_depth16(self.path / self.depth_names[idx])
        frame.rgb = read_rgb(self.path / self.color_names[idx])
        return frame

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        frame = self.load_frame(self.frame_id)
        self.frame_id += 1
        return frame
