"""Sequence protocol (parity: dataset/production/__init__.py:4-39).

Frames carry numpy arrays on host; device transfer happens inside the
jitted pipeline stages (one H2D per frame, not per op).
"""

from __future__ import annotations

import numpy as np


class FrameIntrinsic:
    def __init__(self, fx, fy, cx, cy, dscale):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.dscale = dscale

    def to_K(self):
        return np.asarray([
            [self.fx, 0.0, self.cx],
            [0.0, self.fy, self.cy],
            [0.0, 0.0, 1.0],
        ])

    def scaled(self, s: float) -> "FrameIntrinsic":
        """Intrinsics for an image resized by factor s."""
        return FrameIntrinsic(self.fx * s, self.fy * s, self.cx * s, self.cy * s,
                              self.dscale)


class FrameData:
    def __init__(self):
        # rgb: (H, W, 3) float32 in [0, 1] OR raw uint8; depth: (H, W)
        # float32 metres (NaN invalid) OR raw uint16 counts at
        # calib.dscale counts/metre (0 invalid).  Raw frames convert on
        # device inside the jitted frontend (half the H2D bytes).
        self.rgb = None
        self.depth = None
        self.gt_pose = None    # utils.se3.Isometry | None
        self.calib = None      # FrameIntrinsic


class RGBDSequence:
    def __init__(self):
        self.frame_id = 0

    def __iter__(self):
        return self

    def __len__(self):
        raise NotImplementedError

    def __next__(self) -> FrameData:
        raise NotImplementedError
