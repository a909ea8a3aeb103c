"""Frontend probe on the GPU: each stage of ``preprocess_frame`` alone.

    python -m nerf_fusion_tpu_torch.tools.preprocess_probe

The port's counterpart of the JAX package's ``tools/preprocess_microbench.py``
at its shape: a 640x480 frame, the point cloud at 320x240, its synthetic
depth with 5 % NaN from numpy seed 0 and its intrinsics.  Stages timed:

  * ``resize_half_bilinear`` and ``resize_half_nearest`` 640x480 -> 320x240;
  * ``gradient_xy`` at 640x480;
  * ``unproject_depth`` at 320x240;
  * ``neighbor_count`` alone (the ``stencil_count`` kernel);
  * ``normals_stencil`` alone (the ``stencil_normals`` kernel);
  * both in turn with the PyTorch ops between them
    (``stencil.frontend_points_unfused``: the composition that
    ``frontend_points`` fuses);
  * ``frontend_points`` (the ``stencil_frontend`` kernel);
  * ``box_filter_points_exact`` and the hash filter ``box_filter_points``;
  * the whole ``preprocess_frame``, with either filter.

Each of the three stencil kernels is first held
against its plain version (counts, points and masks exactly, normals by
``NORMAL_DOT`` on ``NORMAL_FRAC`` of the pixels); a mismatch raises.  Device
time and the number of kernels a call come from a profiler trace of ``REPS``
calls (``utils.timing.device_trace``, ``per_call``) and call time from CUDA
events (``utils.timing.call_ms``).  Prints one line per stage and returns
them.  Raises without a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import imgproc, stencil
from ..system.frontend import preprocess_frame
from ..utils.timing import call_ms, device_trace, per_call

H, W = 480, 640
FX, FY, CX, CY = 481.2, 480.0, 319.5, 239.5
CAP = 16384
DEPTH_CUT = (0.1, 8.0)
REPS = 50
NORMAL_DOT = 0.999    # |n . n_plain| above this ...
NORMAL_FRAC = 0.99    # ... on this share of the compared pixels


def synthetic_frame(seed: int = 0):
    """(rgb (H, W, 3), depth (H, W)) as numpy: a smooth depth with 5 % NaN."""
    rng = np.random.default_rng(seed)
    depth = (1.5 + 0.8 * np.sin(np.linspace(0, 6, H))[:, None]
             + 0.3 * np.cos(np.linspace(0, 9, W))[None, :]).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = np.nan
    rgb = rng.random((H, W, 3), dtype=np.float32)
    return rgb, depth


def normal_agreement(n: torch.Tensor, n_ref: torch.Tensor, mask: torch.Tensor) -> float:
    """Share of the masked pixels with |n . n_ref| > NORMAL_DOT (1 if none)."""
    if not bool(mask.any()):
        return 1.0
    dot = (n * n_ref).sum(0)[mask].abs()
    return float((dot > NORMAL_DOT).float().mean())


def frontend_mismatch(out, ref) -> dict:
    """``frontend_points`` output against the plain version's: points
    bitwise, mask pixel for pixel, normals by direction on the mask and
    exactly zero off it."""
    (pts, nrm, valid), (pts_r, nrm_r, valid_r) = out, ref
    return {"pts_equal": torch.equal(pts, pts_r),
            "mask_diff": int((valid != valid_r).sum()),
            "agree_frac": normal_agreement(nrm, nrm_r, valid & valid_r),
            "off_mask_zero": bool((nrm[:, ~valid] == 0).all())}


def frontend_ok(m: dict) -> bool:
    return (m["pts_equal"] and m["mask_diff"] == 0 and m["agree_frac"] >= NORMAL_FRAC
            and m["off_mask_zero"])


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("preprocess_probe measures the GPU; no CUDA device is available")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rgb_np, depth_np = synthetic_frame()
    rgb = torch.as_tensor(rgb_np, device=dev)
    depth = torch.as_tensor(depth_np, device=dev)
    intensity = rgb.mean(dim=-1)
    d1 = imgproc.resize_half_nearest(depth)
    k1 = (FX * 0.5, FY * 0.5, CX * 0.5, CY * 0.5)
    pts = imgproc.unproject_depth(d1, *k1)
    valid = torch.isfinite(d1)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts))

    # the three kernels against their plain versions
    cnt, cnt_p = stencil.neighbor_count(pts0, valid, 0.05), \
        stencil.neighbor_count_plain(pts0, valid, 0.05)
    if not torch.equal(cnt, cnt_p):
        raise RuntimeError("preprocess_probe: neighbor_count differs from its plain version")
    (nrm, ncnt), (nrm_p, ncnt_p) = stencil.normals_stencil(pts0, valid, 0.1), \
        stencil.normals_stencil_plain(pts0, valid, 0.1)
    agree = normal_agreement(nrm, nrm_p, valid & (ncnt_p >= 6))
    if not torch.equal(ncnt, ncnt_p) or agree < NORMAL_FRAC:
        raise RuntimeError(f"preprocess_probe: normals_stencil differs from its plain "
                           f"version (normals agree on {agree:.4f})")
    fused = stencil.frontend_points(d1, *k1)
    mism = frontend_mismatch(fused, stencil.frontend_points_plain(d1, *k1))
    if not frontend_ok(mism):
        raise RuntimeError(f"preprocess_probe: frontend_points differs from its plain "
                           f"version: {mism}")
    _, nrm_f, valid_f = fused
    flat = (pts0.reshape(3, -1).T.contiguous(), nrm_f.reshape(3, -1).T.contiguous(),
            valid_f.reshape(-1), rgb[::2, ::2].reshape(-1, 3))

    def whole():
        return preprocess_frame(rgb, depth, FX, FY, CX, CY, *DEPTH_CUT, CAP)

    stages = {
        "resize_half_bilinear 640x480": lambda: imgproc.resize_half_bilinear(intensity),
        "resize_half_nearest 640x480": lambda: imgproc.resize_half_nearest(depth),
        "gradient_xy 640x480": lambda: imgproc.gradient_xy(intensity),
        "unproject_depth 320x240": lambda: imgproc.unproject_depth(d1, *k1),
        "neighbor_count 320x240": lambda: stencil.neighbor_count(pts0, valid, 0.05),
        "normals_stencil 320x240": lambda: stencil.normals_stencil(pts0, valid, 0.1),
        "count + glue + normals 320x240": lambda: stencil.frontend_points_unfused(d1, *k1),
        "frontend_points 320x240": lambda: stencil.frontend_points(d1, *k1),
        "box_filter_points_exact 76800": lambda: imgproc.box_filter_points_exact(
            flat[0], flat[1], flat[2], voxel_size=0.02, capacity=CAP, colors=flat[3]),
        "box_filter_points (hash) 76800": lambda: imgproc.box_filter_points(
            flat[0], flat[1], flat[2], voxel_size=0.02, capacity=CAP, colors=flat[3]),
        "preprocess_frame 640x480": whole,
        "preprocess_frame 640x480, hash filter": lambda: preprocess_frame(
            rgb, depth, FX, FY, CX, CY, *DEPTH_CUT, CAP, box_filter_exact=False),
    }
    results = {"device": name, "frontend_vs_plain": mism, "normals_agree_frac": agree,
               "stages": {}}
    for stage, fn in stages.items():
        ms, kernels = per_call([e["us"] for e in device_trace(fn, REPS)], REPS)
        call = call_ms(fn, REPS)
        results["stages"][stage] = {"ms": ms, "kernels": kernels, "call_ms": call}
        print(f"{name}: {stage}: {ms:.4f} ms on the device in {kernels} kernels "
              f"({call:.4f} ms per call)", flush=True)
    return results


if __name__ == "__main__":
    main()
