"""ScanNet-export RGB-D sequence reader.

Counterpart of the JAX package's ``data/scannet.py`` for the ScanNet
sensor-export layout:

    scene/
      color/{i}.jpg (or .png)   depth/{i}.png (millimetres)
      pose/{i}.txt              (4x4 camera-to-world; -inf rows = untracked)
      intrinsic/intrinsic_depth.txt (4x4)

An untracked frame repeats the previous pose.  Where the colour and depth
sizes differ, colour is resampled to the depth grid with OpenCV's area
interpolation, as the JAX reader does.  Frames come back on the host at
sensor width (uint8 rgb, uint16 depth counts).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.se3 import Isometry
from .base import FrameData, FrameIntrinsic, RGBDSequence
from .icl_nuim import read_depth16, read_rgb


class ScanNetSequence(RGBDSequence):
    def __init__(self, path: str, start_frame: int = 0, end_frame: int = -1,
                 frame_skip: int = 1, load_gt: bool = True, depth_scale: float = 1000.0):
        super().__init__()
        self.path = Path(path)
        self.depth_scale = depth_scale
        n = len(list((self.path / "depth").glob("*.png")))
        if end_frame == -1:
            end_frame = n
        self.ids = list(range(start_frame, min(end_frame, n), frame_skip))

        K = np.loadtxt(self.path / "intrinsic" / "intrinsic_depth.txt")
        self.calib = FrameIntrinsic(K[0, 0], K[1, 1], K[0, 2], K[1, 2], depth_scale)

        self.gt_trajectory = None
        if load_gt and (self.path / "pose").exists():
            poses = []
            for i in self.ids:
                mat = np.loadtxt(self.path / "pose" / f"{i}.txt")
                if not np.all(np.isfinite(mat)):
                    poses.append(poses[-1] if poses else Isometry())
                else:
                    poses.append(Isometry.from_matrix(mat, ortho=True))
            self.gt_trajectory = poses
        self.first_iso = (self.gt_trajectory[0] if self.gt_trajectory
                          else Isometry())

    def __len__(self):
        return len(self.ids)

    def load_frame(self, idx: int) -> FrameData:
        """Random-access decode; touches no reader state (thread-safe)."""
        i = self.ids[idx]
        depth = read_depth16(self.path / "depth" / f"{i}.png")
        color = self.path / "color" / f"{i}.jpg"
        rgb = read_rgb(color if color.exists() else color.with_suffix(".png"))
        if rgb.shape[:2] != depth.shape:
            import cv2

            rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]),
                             interpolation=cv2.INTER_AREA)

        frame = FrameData()
        frame.gt_pose = (self.gt_trajectory[idx]
                         if self.gt_trajectory is not None else None)
        frame.calib = self.calib
        frame.depth = depth
        frame.rgb = rgb
        return frame

    def __next__(self) -> FrameData:
        if self.frame_id >= len(self):
            raise StopIteration
        frame = self.load_frame(self.frame_id)
        self.frame_id += 1
        return frame
