"""Export a sequence to the ICL-NUIM on-disk layout; the lr-kt workload.

    python -m nerf_fusion_tpu_torch.tools.export_icl_format [OUT_DIR] [--device cuda|cpu]

Counterpart of the JAX repository's ``tools/export_icl_format.py``.
``export_sequence`` writes ``rgb/%d.png`` (uint8), ``depth/%d.png`` (uint16,
1/5000 m) and a TUM-format ``groundtruth.freiburg`` encoded so that
``data.icl_nuim.ICLNUIMSequence`` with the returned ``first_tq`` recovers the
original poses: the encoding inverts the reader's Y-flip and 180-degree Z
canonicalisation.  PNGs are written with OpenCV.

The command writes the lr-kt workload of ``configs/fusion-lr-kt.yaml`` and
``fusion-lr-kt-fast.yaml`` (``export_lrkt``): the synthetic room, 170 frames
at 640x480 at the per-frame camera motion of a 120-frame orbit
(``LRKT_SPAN``), rendered on the device, into ``OUT_DIR`` (default
``output/lrkt_data/lr-kt``), and prints the ``first_tq`` to run them with,
which also lands in ``first_tq.json`` beside the frames.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..utils.se3 import Isometry, Quaternion

LRKT_FRAMES = 170
LRKT_SPAN = 1.2 * (LRKT_FRAMES - 1) / 119.0
LRKT_DIR = Path("output") / "lrkt_data" / "lr-kt"


def encode_tum_pose(iso: Isometry) -> np.ndarray:
    """Pose -> TUM row fields (tx ty tz qx qy qz qw) that the reader inverts."""
    cano_inv = Isometry(q=Quaternion(axis=[0.0, 0.0, 1.0], degrees=180.0)).inv()
    pre = cano_inv.dot(iso)
    F = np.diag([1.0, -1.0, 1.0])
    R_tum = F @ pre.q.rotation_matrix @ F
    t_tum = F @ pre.t
    q = Quaternion(matrix=R_tum).q  # (w, x, y, z)
    return np.concatenate([t_tum, [q[1], q[2], q[3], q[0]]])


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def export_sequence(sequence, out_dir, depth_scale=5000.0):
    """Write every frame of ``sequence`` (``len`` and ``next``) into
    ``out_dir``; returns the ``first_tq`` ([tx, ty, tz, qw, qx, qy, qz], frame
    1's pose) to read it back with."""
    import cv2

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)
    rows = []
    first_tq = None
    for i in range(len(sequence)):
        frame = next(sequence)
        rgb, depth = _host(frame.rgb), _host(frame.depth)
        if rgb.dtype != np.uint8:           # float [0, 1] frames
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(out / "rgb" / f"{i}.png"), np.ascontiguousarray(rgb[..., ::-1]))
        if depth.dtype == np.uint16:
            # raw counts at the source's scale: re-quantise to this layout's
            # depth_scale (counts/metre) where they differ
            src_scale = float(getattr(frame.calib, "dscale", depth_scale))
            if src_scale != depth_scale:
                depth = np.where(depth == 0, np.nan,
                                 depth.astype(np.float32) / src_scale)
        if depth.dtype != np.uint16:        # float metres (NaN invalid)
            depth = np.clip(np.nan_to_num(depth, nan=0.0) * depth_scale,
                            0, 65535).astype(np.uint16)
        cv2.imwrite(str(out / "depth" / f"{i}.png"), depth)
        # row i is frame i in the reader; the reader gives frame 0 row 1's
        # pose (the reference parser's quirk), so the anchor is frame 1's
        rows.append(np.concatenate([[i], encode_tum_pose(frame.gt_pose)]))
        if i == 1:
            first_tq = list(frame.gt_pose.t) + list(frame.gt_pose.q.q)  # t + (w, x, y, z)
    np.savetxt(out / "groundtruth.freiburg", np.stack(rows),
               fmt="%.0f " + " ".join(["%.9f"] * 7))
    return first_tq


def export_lrkt(out_dir=LRKT_DIR, device="cuda", n_frames: int = LRKT_FRAMES,
                width: int = 640, height: int = 480) -> list:
    """The lr-kt workload: the synthetic room at ``LRKT_SPAN`` rendered on
    ``device`` and written to ``out_dir`` unless a complete export is already
    there.  Returns its ``first_tq`` (also in ``first_tq.json``)."""
    from ..data.synth import SyntheticSequence

    out = Path(out_dir)
    tq_path = out / "first_tq.json"
    have = len(list((out / "depth").glob("*.png"))) if (out / "depth").exists() else 0
    if not (tq_path.exists() and (out / "groundtruth.freiburg").exists()
            and have == n_frames):
        seq = SyntheticSequence(n_frames=n_frames, angular_span=1.2 * (n_frames - 1) / 119.0,
                                width=width, height=height, device=device)
        first_tq = export_sequence(seq, out)
        tq_path.write_text(json.dumps([float(x) for x in first_tq]))
    return json.loads(tq_path.read_text())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=str(LRKT_DIR))
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("first_tq:", json.dumps(export_lrkt(args.out_dir, args.device)))


if __name__ == "__main__":
    main()
