#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels (``nerf_fusion_tpu_torch/csrc/*.cu``, one
   ``nvcc`` per source, in parallel), prints the build time and each
   kernel's registers and spills as ptxas reports them, and counts the
   tensor-core instructions in the compiled code of the two decoder
   variants and the encoder (fails if one has none).
2. Holds every kernel against its plain PyTorch version on the card at
   the shapes of the paths below and times both, and the one PyTorch call
   that computes the same function where there is one: device time from
   a profiler trace (``ms``, ``plain_ms``, ``library_ms``), and the
   kernel's call time between CUDA events (``call_ms``), which includes
   the host's cost of issuing it.  The gathers are held bit-exact, NaN
   positions included, and timed with the L2 flushed before each call (a
   128 MB copy, its own events not counted), so that no row reads faster
   than its bound from device memory; ``select_gather`` is held bitwise at
   the fast path's level-0 selection.  The photometric kernel's valid count
   exactly, its H, g and energy to 1e-4 of each output's largest entry, and
   two calls bitwise, at the dense level-0 shape (stride 2, and stride 1
   as ``configs/fusion-lr-kt.yaml`` runs it) and at the fast path's
   24576-pixel selection.  ``gn_step`` on every step of a real frame's GN
   loops (dense and sparse), replayed on copies of the recorded state: the
   new pose within 1e-5 of its largest entry, the decisions equal.  A bound
   is taken at the peak of the unit the kernel computes on
   (``bound_peak``): the decoders' and the encoder's at three TF32
   tensor-core passes, with the f32 CUDA-core bound beside it
   (``bound_f32_ms``).  The fused frontend stencil is held to the plain
   composition: points bitwise, the final mask pixel for pixel, normals
   by direction on the mask and zero off it, two calls bitwise.  The three
   stencil rows are timed a second time after the photometric phase, with
   the kernel names, grids and the number of device events of each trace
   (``utils.timing.device_trace``): a trace can lose events, and
   ``utils.timing.per_call`` reads such a trace by its mean event.
3. Runs nine paths, each with the launch counters zeroed just before:
   (a) the dense fusion loop through its entry point
       (``nerf_fusion_tpu_torch.main configs/fusion-synth.yaml``, 640x480,
       all 100 frames), each tracked frame after the first as CUDA graph
       replays;
   (b) the fast tracking path: the same with the two deltas of
       ``configs/fusion-lr-kt-fast.yaml`` (``rgb.pixel_budget`` 24576,
       ``mesh_reuse_latent_eps`` 0.003) given by ``--exec``;
   (c) the dense path with ``frames_per_call = 19`` (blocks of 19 frames
       between the 20-frame cadences), held within 0.3 mm of (a)'s ATE and
       mesh |SDF|;
   (d) the gather probe (``nerf_fusion_tpu_torch.tools.gather_probe``);
   (e) the frontend probe (``nerf_fusion_tpu_torch.tools.preprocess_probe``);
   (f) ``configs/fusion-lr-kt.yaml`` as it is (stride-1 dense photometric
       term, full-resolution intrinsics at every level, 4 M triangles) on
       the lr-kt workload: the synthetic room, 170 frames at 640x480,
       rendered on the card and written in the ICL-NUIM layout by
       ``tools/export_icl_format.export_lrkt`` (also timed: the reader's
       decode per frame on this host), read back as uint8 / uint16 frames
       through the entry point's ``PrefetchSequence``, uploaded ahead on a
       side stream; its ``first_tq`` from the export;
   (g) ``configs/fusion-lr-kt-fast.yaml`` on the same export;
   (h) ``configs/fusion-scannet-scale.yaml``: the large scene, 400 frames,
       map capacity 65536, 4 M triangles;
   (i) the prior's offline path (``train_path``): LIF generation through
       ``nerf_fusion_tpu_torch.data_generator`` on ``configs/data-simple.yaml``
       at 4 of its 40 shapes, then ``nerf_fusion_tpu_torch.network_trainer``
       on ``configs/train-cnp.yaml`` at its full width (64 LIFs x 4096
       samples a step) for two epochs of 20 steps, with the host sampler and
       again with ``device_data`` and ``steps_per_call: 10``; the trained
       checkpoint folded by ``load_model`` through ``decoder_forward`` and
       ``encoder_forward``, held within 1e-4 of the training modules in eval
       mode.  It prints the step time, the device's idle share, peak memory
       and both samplers' times; it fails unless every logged loss is finite,
       epoch 2's mean ll is below epoch 1's on both runs and the snapshot
       files exist.
   Each fusion path runs in a profiler trace and prints its graph replays,
   host reads and kernels (from the trace) per frame, and its ATE, mesh
   |SDF| (for the lr-kt export against the room's SDF), box-filter drop,
   voxels allocated and triangles; its launch counters must equal this
   repo's kernels in the trace, and each GN group's evaluation through its
   captured graph must give H, g and energy bitwise equal to the same
   functions run eagerly.  Two checks besides: ``preprocess_frame`` on a raw
   lr-kt frame bitwise equal to the frame converted on the host, and the
   first 41 frames of (g) with the frames uploaded ahead bitwise equal to
   a run without a prefetcher (both under PyTorch's deterministic
   algorithms).  Fails unless every kernel launched on some path, the
   photometric kernel, the fused frontend stencil and ``gn_step`` on the
   fusion paths, ``select_gather`` on (b), (g) and (h), the row gather on no
   fusion path and at 1, 2 and 4 on (d), the two standalone stencils on
   (e), the decoder and the encoder on (i), and on every fusion path the
   box filter dropped nothing, the map did not overflow and ATE and mesh
   |SDF| are below the path's gates
   (``GATES``: 20 / 20 mm; lr-kt 20 / 28 mm, lr-kt fast 12 / 20 mm).
4. Prints the ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, if any phase fails or no GPU is
available.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = "configs/fusion-synth.yaml"
FAST_EXEC = "tracking['rgb']['pixel_budget']=24576;mesh_reuse_latent_eps=0.003"
LRKT_CONFIG = "configs/fusion-lr-kt.yaml"
LRKT_FAST_CONFIG = "configs/fusion-lr-kt-fast.yaml"
SCANNET_CONFIG = "configs/fusion-scannet-scale.yaml"
TRAIN_DATA_CONFIG = "configs/data-simple.yaml"
TRAIN_CONFIG = "configs/train-cnp.yaml"
TRAIN_SHAPES = 4        # of the config's 40: about 2700 LIFs
TRAIN_STEPS = 20        # per epoch, two epochs
# (ATE, mesh |SDF|) gates in metres per fusion path; lr-kt's are the JAX
# bench's (bench.py: parity 20 / 28 mm, fast 12 / 20 mm)
GATES = {"dense": (0.02, 0.02), "fast": (0.02, 0.02), "fpc19": (0.02, 0.02),
         "lrkt": (0.02, 0.028), "lrkt_fast": (0.012, 0.02), "scannet_scale": (0.02, 0.02)}
# NVIDIA H100 SXM data sheet peaks (dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12      # CUDA cores
PEAK_TF32_FLOPS = 495e12    # tensor cores
PEAK_BYTES = 3.35e12
# The decoder's hidden layers on the tensor cores, MACs per point: the
# forward pass, and the gradient variant's activation plus three tangents
# (lin1, lin2 and lin3's first 96 inputs; the one-hot tangents of lin0 and
# of lin3's re-fed input are weight rows, no product).
DECODER_TC_MACS = 32 * 128 + 128 * 128 + 128 * 96 + 128 * 128
DECODER_GRAD_TC_MACS = DECODER_TC_MACS + 3 * (128 * 128 + 128 * 96 + 96 * 128)
# The encoder's four layers, all on the tensor cores, MACs per row (the
# function's: the kernel's zero padding of K 6 -> 8 and N 29 -> 32 is not
# counted).
ENCODER_MACS = 6 * 32 + 32 * 64 + 64 * 256 + 256 * 29
# The photometric term per evaluated pixel (the warp: three rows of 2 mul
# + 2 add, a mul and an add, two divisions, two roundings) and per valid
# pixel (the Jacobian, the weight, 21 + 6 + 1 multiply-adds of the sums).
PHOTO_OPS_PIXEL = 24
PHOTO_OPS_VALID = 96
TOL_MLP = 1e-4          # decoder / encoder outputs: f32, summation order only
TOL_HG = 1e-4           # photometric H, g, energy: of each output's largest |entry|
TOL_GRAD = 1e-3         # decoder input gradient
TOL_NORMAL_DOT = 0.999  # |n . n_plain| on 99 % of the valid pixels
TOL_GN = 1e-5           # gn_step's new pose: of its largest |entry| (f32 LU, another library)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """Least time for the work at ``peak`` FLOP/s (the unit the kernel runs
    its operations on) and the HBM rate, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nan_err(out, ref) -> float:
    """Max abs difference over the non-NaN entries; inf if the NaN
    positions differ."""
    import torch

    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    if not torch.equal(nan_o, nan_r):
        return float("inf")
    d = (out - ref)[~nan_o].abs()
    return float(d.max()) if d.numel() else 0.0


def gather_case(fn, plain, args, library, nbytes, shape, flush):
    """One gather held against its plain version and timed beside the
    PyTorch call that computes the same function (``library``, or None),
    each with the L2 flushed before every call; bytes-bound."""
    import torch

    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    out, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    if isinstance(out, tuple):
        err = max(nan_err(a.float(), b.float()) for a, b in zip(out, ref))
    else:
        err = nan_err(out, ref)
    return dict(err=err, shape=shape,
                ms=device_ms(lambda: fn(*args), 100, flush),
                call_ms=call_ms(lambda: fn(*args), 100),
                plain_ms=device_ms(lambda: plain(*args), 100, flush),
                library_ms=None if library is None else device_ms(library, 100, flush),
                bound=bound_ms(0.0, nbytes))


def gather_phase(dev, fr_next):
    """The row gather at the dense warp's, the probe's and the selection's
    shapes, the single-plane row gather, and the lane gather."""
    import numpy as np
    import torch

    from nerf_fusion_tpu_torch.ops import gather, imgproc
    from nerf_fusion_tpu_torch.system.frontend import preprocess_frame
    from nerf_fusion_tpu_torch.tools.gather_probe import warp_indices
    from nerf_fusion_tpu_torch.utils.timing import l2_flush

    rng = np.random.default_rng(0)
    flush = l2_flush(dev)

    def row_case(rows, idx, shape):
        n, c = rows.shape[0], 1 if rows.dim() == 1 else rows.shape[1]
        idx64 = idx.long().clamp(0, n - 1)
        touched = int(torch.unique(idx64).numel())
        m = idx.shape[0]
        return gather_case(gather.row_gather, gather.row_gather_plain, (rows, idx),
                           lambda: torch.index_select(rows, 0, idx64),
                           m * 4 + m * c * 4 + touched * c * 4, shape, flush)

    # (N, 2) [intensity, depth] of a 640x480 frame at the stride-2 warp of
    # the dense photometric term (level 0: 76800 indices)
    c = fr_next.calib
    pre = preprocess_frame(fr_next.rgb, fr_next.depth, c.fx, c.fy, c.cx, c.cy,
                           0.5, 5.0, 40960)
    I0, D0, G0 = pre.pyramid.intensity[0], pre.pyramid.depth[0], pre.pyramid.gradient[0]
    H, W = I0.shape
    rows2 = torch.stack([I0.reshape(-1), D0.reshape(-1)], -1)
    v = np.clip(np.arange(0, H, 2)[:, None] + np.rint(rng.normal(size=(H // 2, W // 2))
                                                       * 1.5).astype(np.int64), 0, H - 1)
    u = np.clip(np.arange(0, W, 2)[None, :] + np.rint(rng.normal(size=(H // 2, W // 2))
                                                       * 1.5).astype(np.int64), 0, W - 1)
    lin = torch.as_tensor((v * W + u).reshape(-1).astype(np.int32), device=dev)
    dense = row_case(rows2, lin, f"({H * W}, 2) at {lin.shape[0]}")
    # the probe's shape: (307200, 2) at 307200 warp-like indices
    rows_p = torch.as_tensor(rng.normal(size=(H * W, 2)).astype(np.float32), device=dev)
    idx_p = torch.as_tensor(warp_indices(rng, H * W, W), device=dev)
    probe = row_case(rows_p, idx_p, f"({H * W}, 2) at {H * W}")
    # the selection of the fast path at level 0: (N, 4) at k = 24576, and
    # the selected pixels against the CPU's selection of the same planes
    sel = imgproc.select_photometric_pixels(I0, D0, G0, 24576, 0.0, stride=2)
    sel_cpu = imgproc.select_photometric_pixels(I0.cpu(), D0.cpu(), G0.cpu(), 24576, 0.0,
                                                stride=2)
    torch.cuda.synchronize()
    sel_match = all(nan_err(a.cpu().float(), b.float()) == 0.0 for a, b in zip(sel, sel_cpu))
    sel_idx = (sel[1] * W + sel[0]).to(torch.int32)
    rows4 = torch.stack([I0.reshape(-1), D0.reshape(-1), G0[0].reshape(-1),
                         G0[1].reshape(-1)], -1)
    select = row_case(rows4, sel_idx, f"({H * W}, 4) at {sel_idx.shape[0]}")
    # the selection's gather as the fast path runs it: the sorted level-0
    # scores and the four planes in place -> seven vectors; per selected
    # pixel 12 bytes in (index, score) and 25 out, and one 32-byte sector of
    # each plane for each distinct sector the selected pixels touch (a
    # sector holds four stride-2 pixels of a row)
    gx, gy = G0[0], G0[1]
    grad2 = gx * gx + gy * gy
    ok = torch.isfinite(grad2) & (grad2 >= 0.0) & torch.isfinite(D0)
    ok &= (torch.arange(H, device=dev)[:, None] % 2 == 0) & \
        (torch.arange(W, device=dev)[None, :] % 2 == 0)
    vals, order = torch.sort(torch.where(ok, grad2, torch.full_like(grad2, -1.0)).reshape(-1),
                             descending=True, stable=True)
    kk = 24576
    sectors = int(torch.unique(order[:kk].clamp(0, H * W - 1) // 8).numel())
    sg_args = (vals, order, kk, W, (I0, D0, gx, gy))
    fused = gather_case(gather.select_gather, gather.select_gather_plain, sg_args, None,
                        kk * (12 + 25) + 4 * 32 * sectors, f"({H * W},) x 4 planes at {kk} "
                        f"of {H * W} sorted, {sectors} sectors a plane", flush)
    plane = rows_p[:, 0].contiguous()
    single = row_case(plane, idx_p, f"({H * W},) at {H * W}")

    # (480, 3200) lane gather; 5 % of the indices negative (wrap once),
    # 1 % >= B and 1 % < -B (NaN)
    B = 3200
    src = torch.as_tensor(rng.normal(size=(H, B)).astype(np.float32), device=dev)
    li = rng.integers(0, B, (H, B))
    pick = rng.random((H, B))
    li = np.where(pick < 0.05, -rng.integers(1, B + 1, (H, B)), li)
    li = np.where((pick >= 0.05) & (pick < 0.06), B + rng.integers(0, 9, (H, B)), li)
    li = np.where((pick >= 0.06) & (pick < 0.07), -B - 1 - rng.integers(0, 9, (H, B)), li)
    lidx = torch.as_tensor(li.astype(np.int32), device=dev)
    wrapped = torch.where(lidx < 0, lidx + B, lidx).long()
    inr = (wrapped >= 0) & (wrapped < B)
    lib_idx = wrapped.clamp(0, B - 1)
    row_ids = torch.arange(H, device=dev)[:, None] * B + lib_idx
    touched = int(torch.unique(row_ids[inr]).numel())
    lane = gather_case(gather.lane_gather, gather.lane_gather_plain, (src, lidx),
                       lambda: torch.gather(src, 1, lib_idx), H * B * 8 + touched * 4,
                       f"({H}, {B}) at ({H}, {B})", flush)
    rows = [
        dict(name="row_gather", err=max(dense["err"], probe["err"], select["err"]), tol=0.0,
             source="nerf_fusion_tpu_torch/csrc/gather.cu",
             replaces="tools/gather_exp3.py:88 (pallas_gather)",
             shape=select["shape"] + " (the selection's shape; the fast path runs "
                                     "select_gather there)",
             ms=select["ms"], call_ms=select["call_ms"], plain_ms=select["plain_ms"],
             bound=select["bound"], library_ms=select["library_ms"],
             selection_matches_cpu=sel_match,
             cases=[dict(case=k, shape=v["shape"], max_abs_err=v["err"], ms=v["ms"],
                         call_ms=v["call_ms"], plain_ms=v["plain_ms"],
                         bound_ms=v["bound"][0], library_ms=v["library_ms"])
                    for k, v in (("dense_warp", dense), ("probe", probe),
                                 ("selection_c4", select))]),
        dict(name="row_gather_c1", err=single["err"], tol=0.0,
             source="nerf_fusion_tpu_torch/csrc/gather.cu",
             replaces="tools/gather_exp3.py:115 (pallas_gather1)", shape=single["shape"],
             ms=single["ms"], call_ms=single["call_ms"], plain_ms=single["plain_ms"],
             bound=single["bound"], library_ms=single["library_ms"]),
        dict(name="lane_gather", err=lane["err"], tol=0.0,
             source="nerf_fusion_tpu_torch/csrc/gather.cu",
             replaces="tools/gather_exp4.py:72 (lane_gather)", shape=lane["shape"],
             ms=lane["ms"], call_ms=lane["call_ms"], plain_ms=lane["plain_ms"],
             bound=lane["bound"], library_ms=lane["library_ms"]),
        dict(name="select_gather", err=fused["err"], tol=0.0,
             source="nerf_fusion_tpu_torch/csrc/gather.cu",
             replaces="tools/gather_exp3.py:88 (pallas_gather) at C = 4, with the rest of "
                      "nerf_fusion_tpu/ops/imgproc.py:428-473 (select_photometric_pixels "
                      "after its top_k)", shape=fused["shape"],
             ms=fused["ms"], call_ms=fused["call_ms"], plain_ms=fused["plain_ms"],
             bound=fused["bound"], library_ms=None),
    ]
    print(f"gather rows timed with the L2 flushed before each call "
          f"({torch.cuda.get_device_name(0)})", flush=True)
    for k, v in (("dense_warp", dense), ("probe", probe), ("selection_c4", select),
                 ("select_gather", fused)):
        if not v["err"] <= 0.0:
            fail(f"{k} differs from its plain version: {v['err']}")
    if not sel_match:
        fail("select_photometric_pixels on the card differs from the CPU's selection")
    return rows


def _warp_touched(level, krkinv, kt, stride, min_grad) -> int:
    """Distinct source rows the photometric kernel reads: those of the
    in-bounds warps of the pixels that pass the tests before the gather
    (the warp as ``imgproc.rgb_odometry`` computes it)."""
    import torch

    from nerf_fusion_tpu_torch.ops import photometric

    if isinstance(level, photometric.Sparse):
        u, v, _, d1, _, _, ok = level.pix
        W, H = level.W, level.H
    else:
        H, W = level.intensity.shape
        gx, gy = level.gradient
        grad2 = gx * gx + gy * gy
        ok = (torch.isfinite(grad2) & (grad2 >= min_grad) & torch.isfinite(level.depth)
              & torch.isfinite(level.intensity) & (level.depth > 0))[::stride, ::stride]
        d1 = level.depth[::stride, ::stride]
        v, u = torch.meshgrid(torch.arange(0, H, stride, device=d1.device, dtype=torch.float32),
                              torch.arange(0, W, stride, device=d1.device, dtype=torch.float32),
                              indexing="ij")
    k = krkinv
    wz = d1 * (k[2, 0] * u + k[2, 1] * v + k[2, 2]) + kt[2]
    u0 = torch.round((d1 * (k[0, 0] * u + k[0, 1] * v + k[0, 2]) + kt[0]) / wz)
    v0 = torch.round((d1 * (k[1, 0] * u + k[1, 1] * v + k[1, 2]) + kt[1]) / wz)
    inb = ok & (u0 >= 0) & (u0 < W) & (v0 >= 0) & (v0 < H)
    lin = (v0[inb] * W + u0[inb]).long()
    return int(torch.unique(lin).numel())


def photometric_phase(dev, seq):
    """The photometric kernel at the dense path's level 0 (640x480 at
    stride 2: 76800 pixels) and at the fast path's 24576-pixel selection,
    on two preprocessed frames of the synthetic sequence and their
    ground-truth relative pose, with the config's photometric settings."""
    import numpy as np
    import torch

    from nerf_fusion_tpu_torch.ops import imgproc, photometric
    from nerf_fusion_tpu_torch.system.frontend import preprocess_frame
    from nerf_fusion_tpu_torch.system.tracker import _intrinsics
    from nerf_fusion_tpu_torch.utils.config import parse_config_yaml
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    rgb = parse_config_yaml(REPO / CONFIG).tracking["rgb"]
    f0, f1 = seq.render_frame(10), seq.render_frame(11)
    c = f0.calib
    pre0, pre1 = (preprocess_frame(f.rgb, f.depth, c.fx, c.fy, c.cx, c.cy, 0.5, 5.0, 40960)
                  for f in (f0, f1))
    rows = imgproc.intensity_depth_rows(pre0.pyramid.intensity[0], pre0.pyramid.depth[0])
    cur = photometric.Dense(pre1.pyramid.intensity[0], pre1.pyramid.depth[0],
                            pre1.pyramid.gradient[0])
    H, W = cur.intensity.shape
    rel = f0.gt_pose.inv().dot(f1.gt_pose).matrix
    dR = torch.as_tensor(np.asarray(rel[:3, :3], np.float32), device=dev)
    dt = torch.as_tensor(np.asarray(rel[:3, 3], np.float32), device=dev)
    K, Kinv = _intrinsics(c.fx, c.fy, c.cx, c.cy, dev)
    krkinv, kt = K @ dR @ Kinv, K @ dt
    stride = int(rgb["stride"])
    kw = dict(min_grad_scale=float(rgb["min_grad_scale"]),
              max_depth_delta=float(rgb["max_depth_delta"]), stride=stride,
              robust_kernel=rgb["robust_kernel"], robust_k=float(rgb["robust_k"]),
              rgb_weight=float(rgb["weight"]))
    sel = photometric.Sparse(W, H, imgproc.select_photometric_pixels(
        *cur, 24576, kw["min_grad_scale"], stride=stride))
    cases = {}
    # dense at the config's stride, the fast path's selection, and dense at
    # stride 1, every pixel of level 0 (configs/fusion-lr-kt.yaml)
    for name, level, st in (("dense", cur, stride), ("sparse", sel, stride),
                            ("dense_stride1", cur, 1)):
        kws = dict(kw, stride=st)
        args = (rows, level, krkinv, kt, c.fx, c.fy, c.cx, c.cy)
        out = photometric.photometric_hg(*args, **kws)
        again = photometric.photometric_hg(*args, **kws)
        ref = photometric.photometric_hg_plain(*args, **kws)
        torch.cuda.synchronize()
        n_pix = (level.pix[0].numel() if name == "sparse"
                 else ((H + st - 1) // st) * ((W + st - 1) // st))
        n_valid = int(ref[3])
        touched = _warp_touched(level, krkinv, kt, st, kw["min_grad_scale"])
        in_bytes = n_pix * (6 * 4 + 1) if name == "sparse" else n_pix * 4 * 4
        cases[name] = dict(
            shape=(f"({H * W}, 2) source, {n_pix} pixels"
                   + (" (selection)" if name == "sparse" else f" (stride {st})")),
            count=float(out[3]), count_plain=float(ref[3]),
            err=max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(out[:3], ref[:3])),
            repeat_equal=all(torch.equal(a, b) for a, b in zip(out, again)),
            ms=device_ms(lambda: photometric.photometric_hg(*args, **kws), 100),
            call_ms=call_ms(lambda: photometric.photometric_hg(*args, **kws), 100),
            plain_ms=device_ms(lambda: photometric.photometric_hg_plain(*args, **kws), 100),
            bound=bound_ms(n_pix * PHOTO_OPS_PIXEL + n_valid * PHOTO_OPS_VALID,
                           in_bytes + touched * 8 + 12 * 4 + 44 * 4))
    for name, v in cases.items():
        if v["count"] != v["count_plain"]:
            fail(f"photometric_hg ({name}): valid count {v['count']} != the plain "
                 f"version's {v['count_plain']}")
        if not v["repeat_equal"]:
            fail(f"photometric_hg ({name}): two calls on the same inputs differ")
        if not v["count"] > 0:
            fail(f"photometric_hg ({name}): no valid pixel")
    d = cases["dense"]
    return [dict(
        name="photometric_hg", err=max(v["err"] for v in cases.values()), tol=TOL_HG,
        source="nerf_fusion_tpu_torch/csrc/photometric.cu",
        replaces="tools/gather_exp3.py:88 (pallas_gather), with "
                 "nerf_fusion_tpu/ops/imgproc.py:524 (rgb_odometry) / :477 "
                 "(rgb_odometry_sparse) and nerf_fusion_tpu/system/tracker.py:175 (_rgb_Hg)",
        shape=d["shape"], ms=d["ms"], call_ms=d["call_ms"], plain_ms=d["plain_ms"],
        bound=d["bound"], library_ms=None,
        cases=[dict(case=k, shape=v["shape"], max_rel_err=v["err"], count=v["count"],
                    count_plain=v["count_plain"], repeat_equal=v["repeat_equal"],
                    ms=v["ms"], call_ms=v["call_ms"], plain_ms=v["plain_ms"],
                    bound_ms=v["bound"][0], bound_by=v["bound"][1])
               for k, v in cases.items()])]


def gn_phase(dev, seq, model):
    """The GN step kernel against its plain version on the (H, g, energy,
    state) sequences of real frames: frame 10 integrated into a fresh map
    at its ground-truth pose, frame 11 tracked eagerly against it with the
    config's schedule, dense and with the fast path's 24576-pixel
    selection.  Every step the loop took is recorded and replayed on copies
    of its state: the new poses within TOL_GN of their largest entry, the
    decisions (done, used, i, iters, the best energy) equal."""
    import torch

    from nerf_fusion_tpu_torch.ops import gn
    from nerf_fusion_tpu_torch.system import tracker as T
    from nerf_fusion_tpu_torch.system.map import SparseVoxelMap
    from nerf_fusion_tpu_torch.utils.config import dict_to_args, parse_config_yaml
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    args = parse_config_yaml(REPO / CONFIG)
    f0, f1 = seq.render_frame(10), seq.render_frame(11)
    c = f0.calib
    vmap = SparseVoxelMap(model, dict_to_args(args.mapping), 29, dev)
    tracker = T.SDFTracker(vmap, args.tracking, point_budget=40960)
    pre0 = tracker.preprocess(f0.rgb, f0.depth, c)
    pre1 = tracker.preprocess(f1.rgb, f1.depth, c)
    R0 = torch.as_tensor(f0.gt_pose.q.rotation_matrix, dtype=torch.float32, device=dev)
    t0 = torch.as_tensor(f0.gt_pose.t, dtype=torch.float32, device=dev)
    vmap.integrate_keyframe(pre0.points, pre0.normals, pre0.mask, pose=(R0, t0))
    steps = []

    def record(H, g, energy, state, group, n_iters):
        steps.append((H.clone(), g.clone(), energy.clone(),
                      gn.GNState(*(x.clone() for x in state)), group, n_iters))
        gn.gn_step(H, g, energy, state, group, n_iters)

    for budget in (0, 24576):
        tcfg = tracker.tcfg._replace(rgb_pixel_budget=budget)
        T.track_gauss_newton(vmap.state, vmap.cfg, model.decoder, tcfg, pre0.pyramid,
                             pre1.pyramid, pre1.points[:8192], pre1.mask[:8192], R0, t0,
                             torch.eye(3, device=dev), torch.zeros(3, device=dev),
                             c.fx, c.fy, c.cx, c.cy, tracker.rgb_weight, vmap.bound_min,
                             step=record)
    err, same = 0.0, True
    for H, g, energy, state, group, n_iters in steps:
        a = gn.GNState(*(x.clone() for x in state))
        b = gn.GNState(*(x.clone() for x in state))
        gn.gn_step(H, g, energy, a, group, n_iters)
        gn.gn_step_plain(H, g, energy, b, group, n_iters)
        torch.cuda.synchronize()
        scale = max(float(b.pose[:24].abs().max()), 1.0)
        err = max(err, float((a.pose[:24] - b.pose[:24]).abs().max()) / scale)
        same &= (torch.equal(a.ints, b.ints) and torch.equal(a.done, b.done)
                 and torch.equal(a.iters, b.iters) and torch.equal(a.pose[24:], b.pose[24:]))
    H, g, energy, state, group, n_iters = steps[len(steps) // 2]
    work = gn.GNState(*(x.clone() for x in state))
    # one thread's solve, exp and compose: about 600 operations; 280 bytes in
    # (H, g, energy, pose, ints) and 113 out (pose, ints, done, iters)
    print(f"gn_step: {len(steps)} recorded steps of frame 11 (dense and sparse), pose "
          f"max rel err {err:.3e}, decisions equal {same}", flush=True)
    if not same:
        fail("gn_step's decisions differ from its plain version's")
    return [dict(
        name="gn_step", err=err, tol=TOL_GN, source="nerf_fusion_tpu_torch/csrc/gn.cu",
        replaces="none (no Pallas source): the while_loop body of "
                 "nerf_fusion_tpu/system/tracker.py:288-310",
        shape=f"(6, 6) + (6,) + () + state, {len(steps)} recorded steps",
        ms=device_ms(lambda: gn.gn_step(H, g, energy, work, group, n_iters), 100),
        call_ms=call_ms(lambda: gn.gn_step(H, g, energy, work, group, n_iters), 100),
        plain_ms=device_ms(lambda: gn.gn_step_plain(H, g, energy, work, group, n_iters), 20),
        bound=bound_ms(600.0, 280 + 113), library_ms=None, recorded_steps=len(steps))]


def kernel_phase(dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.models.io import load_model
    from nerf_fusion_tpu_torch.ops import imgproc, mlp, stencil
    from nerf_fusion_tpu_torch.system.mesher import _sample_offsets
    from nerf_fusion_tpu_torch.tools.preprocess_probe import frontend_mismatch, frontend_ok
    from nerf_fusion_tpu_torch.utils.timing import (call_ms, device_ms, device_trace,
                                                    per_call)

    model, _ = load_model(REPO / "ckpt/default/hyper.json", 300)
    model.to(dev)
    dec, enc = model.decoder, model.encoder
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # decoder forward: one mesher chunk, 512 voxels x 512 samples at r = 4
    lat = 0.3 * torch.randn(512, 29, device=dev, generator=gen)
    offs = torch.as_tensor(_sample_offsets(4), device=dev)
    x = torch.cat([lat.repeat_interleave(offs.shape[0], 0), offs.repeat(512, 1)], 1)
    n = x.shape[0]
    out = mlp.decoder_forward(x, dec.packed, dec.mats)
    ref = mlp.decoder_forward_plain(x, dec.mats)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rows.append(dict(
        name="decoder_forward", err=err, tol=TOL_MLP,
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="nerf_fusion_tpu/ops/pallas_mlp.py:98 (_decoder_pallas_call)",
        shape=f"({n}, 32) -> ({n}, 2)",
        ms=device_ms(lambda: mlp.decoder_forward(x, dec.packed, dec.mats)),
        call_ms=call_ms(lambda: mlp.decoder_forward(x, dec.packed, dec.mats)),
        plain_ms=device_ms(lambda: mlp.decoder_forward_plain(x, dec.mats)),
        bound=bound_ms(3 * 2 * DECODER_TC_MACS * n, n * (32 + 2) * 4 + 49890 * 4,
                       PEAK_TF32_FLOPS),
        bound_f32=bound_ms(2 * 49408 * n, n * (32 + 2) * 4 + 49890 * 4)))

    # decoder forward + input gradient: the tracker's GN point budget
    n = 8192
    xg = torch.cat([0.3 * torch.randn(n, 29, device=dev, generator=gen),
                    torch.rand(n, 3, device=dev, generator=gen) - 0.5], 1)
    out, grad = mlp.decoder_forward_grad(xg, dec.packed, dec.mats)
    ref, gref = mlp.decoder_forward_grad_plain(xg, dec.mats)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    gdiff = (grad - gref).abs().amax(dim=1)
    rows.append(dict(
        name="decoder_forward_grad", err=err, tol=TOL_MLP,
        grad_err=float(gdiff.max()), grad_tol=TOL_GRAD,
        grad_within_tol=float((gdiff <= TOL_GRAD).float().mean()),
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="nerf_fusion_tpu/ops/pallas_mlp.py:98 (_decoder_pallas_call)",
        shape=f"({n}, 32) -> ({n}, 2) + ({n}, 3)",
        ms=device_ms(lambda: mlp.decoder_forward_grad(xg, dec.packed, dec.mats)),
        call_ms=call_ms(lambda: mlp.decoder_forward_grad(xg, dec.packed, dec.mats)),
        plain_ms=device_ms(lambda: mlp.decoder_forward_grad_plain(xg, dec.mats)),
        bound=bound_ms(3 * 2 * DECODER_GRAD_TC_MACS * n, n * (32 + 2 + 3) * 4 + 49890 * 4,
                       PEAK_TF32_FLOPS),
        bound_f32=bound_ms(2 * (49408 + 3 * (128 * 128 + 128 * 96 + 96 * 128 + 128)) * n,
                           n * (32 + 2 + 3) * 4 + 49890 * 4)))

    # encoder: 8 corner pairs x points_capacity 40960
    n = 8 * 40960
    rel = torch.rand(n, 3, device=dev, generator=gen) * 2.0 - 1.0
    nrm = torch.nn.functional.normalize(torch.randn(n, 3, device=dev, generator=gen), dim=1)
    xe = torch.cat([rel, nrm], 1).contiguous()
    out = mlp.encoder_forward(xe, enc.packed, enc.mats)
    ref = mlp.encoder_forward_plain(xe, enc.mats)
    torch.cuda.synchronize()
    rows.append(dict(
        name="encoder_forward",
        err=float((out - ref).abs().max()), tol=TOL_MLP,
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="nerf_fusion_tpu/ops/pallas_mlp.py:165 (_encoder_pallas_call)",
        shape=f"({n}, 6) -> ({n}, 29)",
        ms=device_ms(lambda: mlp.encoder_forward(xe, enc.packed, enc.mats)),
        call_ms=call_ms(lambda: mlp.encoder_forward(xe, enc.packed, enc.mats)),
        plain_ms=device_ms(lambda: mlp.encoder_forward_plain(xe, enc.mats)),
        bound=bound_ms(3 * 2 * ENCODER_MACS * n, n * (6 + 29) * 4 + mlp.ENCODER_PACKED * 4,
                       PEAK_TF32_FLOPS),
        bound_f32=bound_ms(2 * ENCODER_MACS * n,
                           n * (6 + 29) * 4 + mlp.ENCODER_PACKED * 4)))

    # stencils: the frontend's 320x240 point planes of a rendered frame
    seq = SyntheticSequence(n_frames=100, width=640, height=480, device=dev)
    fr = seq.render_frame(0)
    depth = fr.depth
    depth = torch.where((depth < 0.5) | (depth > 5.0), torch.nan, depth)
    d1 = imgproc.resize_half_nearest(depth)
    c = fr.calib
    pts = imgproc.unproject_depth(d1, c.fx * 0.5, c.fy * 0.5, c.cx * 0.5, c.cy * 0.5)
    valid = torch.isfinite(d1)
    pts0 = torch.where(valid[None], pts, torch.zeros_like(pts)).contiguous()
    H, W = valid.shape
    px = H * W

    cnt = stencil.neighbor_count(pts0, valid, 0.05)
    cref = stencil.neighbor_count_plain(pts0, valid, 0.05)
    torch.cuda.synchronize()
    n_valid = int(valid.sum())
    n_acc = float(cref.sum())
    rows.append(dict(
        name="stencil_count",
        err=float((cnt - cref).abs().max()), tol=0.0,
        source="nerf_fusion_tpu_torch/csrc/stencil.cu",
        replaces="nerf_fusion_tpu/ops/pallas_stencil.py:202 (_padded_call via "
                 "neighbor_count_pallas :238)",
        shape=f"(3, {H}, {W}) + ({H}, {W}) -> ({H}, {W})",
        ms=device_ms(lambda: stencil.neighbor_count(pts0, valid, 0.05), 100),
        call_ms=call_ms(lambda: stencil.neighbor_count(pts0, valid, 0.05), 100),
        plain_ms=device_ms(lambda: stencil.neighbor_count_plain(pts0, valid, 0.05)),
        bound=bound_ms(n_valid * 49 * 8 + n_acc, px * (13 + 4))))

    gated = valid & (cref - 1.0 >= 16)
    nrm_k, cnt_k = stencil.normals_stencil(pts0, gated, 0.1)
    nrm_p, cnt_p = stencil.normals_stencil_plain(pts0, gated, 0.1)
    torch.cuda.synchronize()
    m = gated & (cnt_p >= 6)
    dot = (nrm_k * nrm_p).sum(0)[m].abs()
    frac = float((dot > TOL_NORMAL_DOT).float().mean())
    n_valid = int(gated.sum())
    n_acc = float(cnt_p.sum())
    rows.append(dict(
        name="stencil_normals",
        err=float((nrm_k - nrm_p)[:, m].abs().max()), tol=None,
        normal_agree_frac=frac, count_err=float((cnt_k - cnt_p).abs().max()),
        source="nerf_fusion_tpu_torch/csrc/stencil.cu",
        replaces="nerf_fusion_tpu/ops/pallas_stencil.py:202 (_padded_call via "
                 "normals_stencil_pallas :218)",
        shape=f"(3, {H}, {W}) + ({H}, {W}) -> (3, {H}, {W}) + ({H}, {W})",
        ms=device_ms(lambda: stencil.normals_stencil(pts0, gated, 0.1), 100),
        call_ms=call_ms(lambda: stencil.normals_stencil(pts0, gated, 0.1), 100),
        plain_ms=device_ms(lambda: stencil.normals_stencil_plain(pts0, gated, 0.1)),
        bound=bound_ms(n_valid * (49 * 8 + 100) + n_acc * 16, px * (13 + 16))))

    # the fused frontend stencil on the same depth plane with the frontend's
    # gates: both windows' operations as the two rows above count them plus
    # the unprojection (6 a pixel); one depth plane in, seven planes out
    k1 = (c.fx * 0.5, c.fy * 0.5, c.cx * 0.5, c.cy * 0.5)
    fused = stencil.frontend_points(d1, *k1)
    again = stencil.frontend_points(d1, *k1)
    plain = stencil.frontend_points_plain(d1, *k1)
    torch.cuda.synchronize()
    mism = frontend_mismatch(fused, plain)
    m = fused[2] & plain[2]
    rows.append(dict(
        name="stencil_frontend",
        err=float((fused[1] - plain[1])[:, m].abs().max()), tol=None,
        normal_agree_frac=mism["agree_frac"], **mism,
        repeat_equal=all(torch.equal(a, b) for a, b in zip(fused, again)),
        source="nerf_fusion_tpu_torch/csrc/stencil.cu",
        replaces="nerf_fusion_tpu/ops/pallas_stencil.py:202 (_padded_call via "
                 "neighbor_count_pallas :238 and normals_stencil_pallas :218, composed as "
                 "nerf_fusion_tpu/system/frontend.py:96-110)",
        shape=f"({H}, {W}) -> (3, {H}, {W}) + (3, {H}, {W}) + ({H}, {W})",
        ms=device_ms(lambda: stencil.frontend_points(d1, *k1), 100),
        call_ms=call_ms(lambda: stencil.frontend_points(d1, *k1), 100),
        plain_ms=device_ms(lambda: stencil.frontend_points_plain(d1, *k1)),
        bound=bound_ms(px * 6 + int(valid.sum()) * 49 * 8 + float(cref.sum())
                       + n_valid * (49 * 8 + 100) + n_acc * 16, px * (4 + 25))))
    retime = {"stencil_count": lambda: stencil.neighbor_count(pts0, valid, 0.05),
              "stencil_normals": lambda: stencil.normals_stencil(pts0, gated, 0.1),
              "stencil_frontend": lambda: stencil.frontend_points(d1, *k1)}

    rows += gather_phase(dev, seq.render_frame(1))
    rows += photometric_phase(dev, seq)
    rows += gn_phase(dev, seq, model)
    # the stencil rows once more, after the photometric phase, event by event
    for r in rows:
        if r["name"] in retime:
            events = device_trace(retime[r["name"]], 100)
            us = sorted(e["us"] for e in events)
            r["ms_again"] = per_call(us, 100)[0]
            print(f"kernel {r['name']}: {r['ms']:.4f} ms where it stands, "
                  f"{r['ms_again']:.4f} ms after the photometric phase: {len(events)} "
                  f"device events in 100 calls, min / median / max "
                  f"{us[0]:.3f} / {us[len(us) // 2]:.3f} / {us[-1]:.3f} us, kernels "
                  f"{sorted({(e['name'][-40:], str(e['grid']), str(e['block'])) for e in events})}",
                  flush=True)
    for r in rows:
        extra = {k: r[k] for k in ("grad_err", "grad_within_tol", "normal_agree_frac",
                                   "count_err", "mask_diff", "pts_equal", "off_mask_zero",
                                   "repeat_equal", "library_ms", "selection_matches_cpu")
                 if k in r}
        if "bound_f32" in r:
            extra["bound_f32_ms"] = r["bound_f32"][0]
        print(f"kernel {r['name']}: {r['shape']} max_abs_err {r['err']:.3e} {extra} "
              f"kernel {r['ms']:.4f} ms on the device ({r['call_ms']:.4f} ms per call) "
              f"plain {r['plain_ms']:.4f} ms bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})", flush=True)
    for r in rows:
        if r["tol"] is not None and not r["err"] <= r["tol"]:
            fail(f"{r['name']} max abs err {r['err']} > {r['tol']}")
    # A ReLU pre-activation within rounding of 0 may take the other side in
    # the kernel than in the plain version; the input gradient jumps there.
    # So the gradient is held on all but 0.1 % of the points.
    if rows[4]["count_err"] != 0.0:
        fail(f"stencil_normals count differs from the plain version by up to "
             f"{rows[4]['count_err']}")
    if rows[4]["normal_agree_frac"] < 0.99:
        fail(f"stencil_normals: only {rows[4]['normal_agree_frac']:.4f} of the "
             f"pixels with |n.n_plain| > {TOL_NORMAL_DOT}")
    f = rows[5]
    print(f"stencil_frontend: final mask differs from the plain version's on "
          f"{f['mask_diff']} pixels", flush=True)
    if not (frontend_ok(f) and f["repeat_equal"]):
        held = {k: f[k] for k in ("pts_equal", "mask_diff", "agree_frac", "off_mask_zero",
                                  "repeat_equal")}
        fail(f"stencil_frontend differs from the plain composition: {held}")
    g = rows[1]
    if g["grad_within_tol"] < 0.999:
        fail(f"decoder_forward_grad: gradient within {TOL_GRAD} on only "
             f"{g['grad_within_tol']:.5f} of the points")
    return rows


KERNEL_ROWS = ("decoder_forward", "decoder_forward_grad", "encoder_forward",
               "stencil_count", "stencil_normals", "stencil_frontend", "row_gather",
               "row_gather_c1", "lane_gather", "photometric_hg", "select_gather", "gn_step")


def ptxas_report(report: dict):
    """Registers, spills and errors from ``nvcc -Xptxas=-v``, per kernel."""
    for name, r in report.items():
        fn = ""
        for line in r["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {fn[-48:]}: {line.strip()}")


def tensor_core_counts() -> dict:
    """Tensor-core instructions in each MLP kernel (the two decoder
    instantiations and the encoder): HMMA/HGMMA in the SASS of the built
    library (``cuobjdump -sass``) or, where the toolkit has no cuobjdump,
    mma/wgmma in the PTX of the same source."""
    from nerf_fusion_tpu_torch.ops import cuda_build

    kernels = {"decoder_forward": "decoder_kernelILb0E",
               "decoder_forward_grad": "decoder_kernelILb1E",
               "encoder_forward": "encoder_kernel"}
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if cuobjdump.exists():
        cmd = [str(cuobjdump), "-sass", str(cuda_build.library_path("mlp"))]
        header, instr = r"\n\s*Function : ", r"\bH(?:G)?MMA\b"
    else:
        cmd = [cuda_build.nvcc_path(), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx", "-o", "-",
               str(cuda_build.CSRC_DIR / "mlp.cu")]
        header, instr = r"\.entry\s+", r"\b(?:wgmma\.mma_async|mma\.sync)\b"
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"{' '.join(cmd[:2])} failed: {out.stderr.strip()[-2000:]}")
    counts = {}
    for body in re.split(header, out.stdout)[1:]:
        fn = body.split(None, 1)[0]
        for name, key in kernels.items():
            if key in fn:
                counts[name] = len(re.findall(instr, body))
    print(f"tensor-core instructions ({Path(cmd[0]).name}): {counts}", flush=True)
    for name in kernels:
        if not counts.get(name):
            fail(f"{name}: no tensor-core instruction in its compiled code")
    return counts


def zero_launches():
    from nerf_fusion_tpu_torch.ops import launches

    launches.reset()


def read_launches() -> dict:
    """Launches per kernel row; the row gather is split by row width: C = 2
    and 4 are ``pallas_gather``'s counterpart, C = 1 ``pallas_gather1``'s."""
    from nerf_fusion_tpu_torch.ops import launches

    n = launches.snapshot()
    by_c = {c: n[f"row_gather_c{c}"] for c in (1, 2, 4)}
    out = {k: v for k, v in n.items() if not k.startswith("row_gather")}
    out.update(row_gather=by_c[2] + by_c[4], row_gather_c1=by_c[1], row_gather_by_width=by_c)
    return out


def trace_counts(prof) -> tuple:
    """(this repo's kernels by counter, all device kernels) in a trace.  Reads
    the profiler's flat event list: ``prof.events()`` builds the CPU call tree
    first, which did not end within 15 minutes for the 400-frame path."""
    from torch.autograd import DeviceType

    from nerf_fusion_tpu_torch.ops import launches

    mine, total = dict.fromkeys(launches.NAMES, 0), 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name.startswith(("Memcpy", "Memset")):
            continue
        total += 1
        counter = launches.counter_of(name)
        if counter is not None:
            mine[counter] += 1
    return mine, total


def fusion_path(dev, label: str, exec_: str = None, config: str = CONFIG):
    """The fusion loop through its entry point, launch counters zeroed, in a
    profiler trace: the counters must equal the trace's kernels.  Fails on
    the path's ATE and mesh |SDF| gates (``GATES``), a box-filter drop, a
    map overflow or an empty mesh."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_fusion_tpu_torch import main as entry
    from nerf_fusion_tpu_torch.data.synth import scene_sdf
    from nerf_fusion_tpu_torch.ops import launches
    from nerf_fusion_tpu_torch.tools.graph_check import graph_vs_eager
    from nerf_fusion_tpu_torch.utils.evaluate import mesh_abs_sdf_error

    out_dir = REPO / "output" / "chip_smoke" / label
    argv = [str(REPO / config), "--device", str(dev), "--output", str(out_dir)]
    if exec_:
        argv += ["--exec", exec_]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    # the device's events only: with the host's operators recorded too, the
    # scannet-scale path (its renderer launches about 8000 kernels a frame)
    # took 284 s of wall time on an H100
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe, res = entry.run(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = launches.snapshot()
    launches_ = read_launches()
    traced, total = trace_counts(prof)
    if "mesh_abs_sdf" not in res:
        # a disk reader has no scene SDF: the lr-kt export is the synthetic
        # room in its own world frame (read with the exported first_tq)
        res["mesh_abs_sdf"] = mesh_abs_sdf_error(pipe.mesher.current_mesh(), scene_sdf,
                                                 device=dev)
    tr = pipe.tracker
    n = res["n_frames"]
    tracked = tr.n_tracked - 1
    stages = {k: round(v["mean_ms"], 3) for k, v in res["timing"].items()}
    print(f"{label} path: {n} frames in {wall:.2f} s ({n / wall:.2f} fps incl. "
          f"rendering or reading, output and the profiler), stage mean ms {stages}",
          flush=True)
    print(f"{label} path: per tracked frame {tr.graph_replays / tracked:.2f} graph replays, "
          f"{tr.host_reads / tracked:.2f} host reads; {total / n:.1f} kernels per frame in "
          f"the trace ({torch.cuda.get_device_name(0)})", flush=True)
    print(f"{label} path: ATE {1e3 * res['ate_rmse']:.3f} mm, mesh |SDF| "
          f"{1e3 * res['mesh_abs_sdf']:.3f} mm, {res['n_triangles']} triangles, "
          f"{res['map']['n_occupied']} voxels allocated of "
          f"{pipe.map.cfg.latent_capacity}, map overflow {res['map']['overflow']}, "
          f"box-filter drop_frac {res['box_filter_drop_frac']}, wall {wall:.2f} s, "
          f"launches {launches_}", flush=True)
    if "mesh_reuse" in res:
        print(f"{label} path: latent-reuse gate skipped {res['mesh_reuse']['skipped']} "
              f"of {res['mesh_reuse']['updated']} updated voxels", flush=True)
    ate_gate, mesh_gate = GATES[label]
    if traced != counted:
        fail(f"{label}: launch counters {counted} differ from the trace's kernels {traced}")
    if res["box_filter_drop_frac"]["max"] != 0.0:
        fail(f"{label}: box filter dropped points: {res['box_filter_drop_frac']}")
    try:
        pipe.map.check_overflow()
    except RuntimeError as e:
        fail(f"{label}: {e} ({res['map']['n_occupied']} voxels allocated)")
    if not res["ate_rmse"] < ate_gate:
        fail(f"{label}: ATE {res['ate_rmse']} m >= {ate_gate}")
    if not res["mesh_abs_sdf"] < mesh_gate:
        fail(f"{label}: mesh |SDF| {res['mesh_abs_sdf']} m >= {mesh_gate}")
    if res["n_triangles"] <= 0:
        fail(f"{label}: empty mesh")
    if tr.graph_replays <= 0 or tr.host_reads > tr.graph_replays:
        fail(f"{label}: {tr.graph_replays} graph replays, {tr.host_reads} host reads")
    # one evaluation of each group through its graph and eagerly, bitwise
    for group in range(len(tr.tcfg.iter_config)):
        got, ref = graph_vs_eager(tr, group)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{label}: group {group}'s captured evaluation differs from the eager "
                 f"one: {[float((a - b).abs().max()) for a, b in zip(got, ref)]}")
    print(f"{label} path: launch counters equal the trace's kernels; H, g, energy of each "
          f"group's captured evaluation bitwise equal to the eager call", flush=True)
    res["wall_s"] = wall
    return launches_, res


def lrkt_export(dev) -> str:
    """The lr-kt workload (the synthetic room, 170 frames at 640x480, in the
    ICL-NUIM layout), rendered on the card and written under ``output/``;
    returns the ``--exec`` that points the lr-kt configs at it."""
    import cv2

    from nerf_fusion_tpu_torch.data.icl_nuim import ICLNUIMSequence
    from nerf_fusion_tpu_torch.tools.export_icl_format import export_lrkt

    out = REPO / "output" / "lrkt_data" / "lr-kt"
    t0 = time.perf_counter()
    first_tq = export_lrkt(out, device=dev)
    print(f"lr-kt export: {len(list((out / 'rgb').glob('*.png')))} frames in {out} "
          f"({time.perf_counter() - t0:.2f} s), first_tq {first_tq}", flush=True)
    # the reader's decode on this host, one thread, every frame once
    reader = ICLNUIMSequence(str(out), first_tq=first_tq, load_gt=True)
    t0 = time.perf_counter()
    for i in range(len(reader)):
        reader.load_frame(i)
    print(f"lr-kt decode: {1e3 * (time.perf_counter() - t0) / len(reader):.3f} ms a frame "
          f"(640x480 rgb + depth PNG, OpenCV {cv2.__version__}, one thread)", flush=True)
    raw_frame_check(dev, reader.load_frame(10))
    return f"sequence_kwargs['path']='{out}';sequence_kwargs['first_tq']={first_tq}"


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms: on the card ``index_add_`` (the box
    filter's and the map's segment sums) otherwise adds with atomics, in an
    order that varies from call to call, so two runs agree to rounding only."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def raw_frame_check(dev, frame):
    """``preprocess_frame`` on the card on a raw frame (uint8 rgb, uint16
    depth counts) and on the same frame converted on the host with numpy's
    float32 divisions: every output bitwise equal, NaN positions included
    (under ``deterministic()``: the box filter's averages)."""
    import numpy as np
    import torch

    from nerf_fusion_tpu_torch.system.frontend import preprocess_frame

    c = frame.calib
    rgb_f = frame.rgb.astype(np.float32) / np.float32(255.0)
    depth_f = np.where(frame.depth == 0, np.float32(np.nan),
                       frame.depth.astype(np.float32) / np.float32(c.dscale))
    with deterministic():
        outs = [preprocess_frame(torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
                                 torch.from_numpy(np.ascontiguousarray(depth)).to(dev),
                                 c.fx, c.fy, c.cx, c.cy, 0.5, 5.0, 40960,
                                 depth_scale=c.dscale)
                for rgb, depth in ((frame.rgb, frame.depth), (rgb_f, depth_f))]
        torch.cuda.synchronize()

    def flat(p):
        return [*p.pyramid.intensity, *p.pyramid.depth, *p.pyramid.gradient, p.points,
                p.normals, p.colors, p.mask, p.drop_frac]

    same = [torch.equal(torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0))
            and torch.equal(a.isnan(), b.isnan()) if a.is_floating_point() else torch.equal(a, b)
            for a, b in zip(flat(outs[0]), flat(outs[1]))]
    print(f"raw frame (uint8 / uint16) against the host-converted float frame: "
          f"{sum(same)} of {len(same)} outputs of preprocess_frame bitwise equal, "
          f"{int(outs[0].mask.sum())} points", flush=True)
    if not all(same):
        fail(f"the raw-frame frontend differs from the float path: {same}")


def prefetch_check(dev, lrkt_exec: str, n_frames: int = 41):
    """``configs/fusion-lr-kt-fast.yaml`` on its first ``n_frames`` frames with
    the frames uploaded ahead on a side stream (``prefetch_upload``, twice)
    and read without a prefetcher: the trajectories must be bitwise equal.
    All runs under ``deterministic()``."""
    import numpy as np
    import torch

    from nerf_fusion_tpu_torch import main as entry

    trajs = {}
    with deterministic():
        for label, extra in (("upload", "prefetch_upload=True"), ("direct", "prefetch=False"),
                             ("upload_again", "prefetch_upload=True")):
            argv = [str(REPO / LRKT_FAST_CONFIG), "--device", str(dev), "--max_frames",
                    str(n_frames), "--output", str(REPO / "output" / "chip_smoke" / label),
                    "--exec", f"{lrkt_exec};{extra}"]
            t0 = time.perf_counter()
            pipe, res = entry.run(argv)
            torch.cuda.synchronize()
            trajs[label] = np.stack([p.matrix for p in pipe.trajectory()])
            print(f"prefetch check, {label}: {n_frames} frames in "
                  f"{time.perf_counter() - t0:.2f} s, ATE {1e3 * res['ate_rmse']:.3f} mm",
                  flush=True)
    for label in ("direct", "upload_again"):
        diff = float(np.abs(trajs[label] - trajs["upload"]).max())
        print(f"prefetch check: upload vs {label}: max |pose difference| {diff:.3e}",
              flush=True)
        if not np.array_equal(trajs[label], trajs["upload"]):
            fail(f"prefetch upload: the trajectory differs from the {label} run's by "
                 f"up to {diff}")


def train_path(dev):
    """The prior's offline path through its two entry points: LIF generation
    (``configs/data-simple.yaml`` at ``TRAIN_SHAPES`` shapes), then the trainer
    on ``configs/train-cnp.yaml`` at its full width for two epochs of
    ``TRAIN_STEPS`` steps, once as the config gives it (host sampler) and once
    with ``device_data: true`` and ``steps_per_call: 10``, and at its end the
    trained checkpoint folded by ``load_model`` and run through
    ``decoder_forward`` (262144 rows: one training batch's decoder input) and
    ``encoder_forward`` (327680 surface rows).  Launch counters zeroed before
    the path.  Fails unless every logged loss is finite, epoch 2's mean ll is
    below epoch 1's on both runs, the snapshot files exist and the kernels'
    outputs are within ``TOL_MLP`` of the training modules in eval mode.
    Prints per run the step time over steps 11-20 (CUDA events), the device's
    busy time and idle share over steps 31-40 (a profiler trace of the
    device), peak memory, and the two samplers' times for one batch (the
    host's on its clock, the device's as device time and as call time)."""
    import shutil

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_fusion_tpu_torch import data_generator, network_trainer
    from nerf_fusion_tpu_torch.data.device_lif import DeviceLifDataset
    from nerf_fusion_tpu_torch.data.lif_dataset import LifDataset
    from nerf_fusion_tpu_torch.models import io
    from nerf_fusion_tpu_torch.models.encoder import EncoderConfig, TrainEncoder
    from nerf_fusion_tpu_torch.utils.config import parse_config_json
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    out = REPO / "output" / "chip_smoke" / "train"
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    lif_dir = data_generator.main([str(REPO / TRAIN_DATA_CONFIG), "--exec",
                                   f"provider_kwargs['n_shapes']={TRAIN_SHAPES};"
                                   f"output='{out / 'lif'}'"])
    gen_s = time.perf_counter() - t0
    n_lifs = len(json.loads((lif_dir / "source.json").read_text()))
    print(f"train path: {n_lifs} LIFs from {TRAIN_SHAPES} shapes in {gen_s:.2f} s "
          f"(host: numpy, scipy and the native sampler)", flush=True)
    if n_lifs < 64:
        fail(f"train: the generator gave {n_lifs} LIFs, fewer than one batch")

    runs = {}
    for label, extra in (("host", ""), ("device", ";device_data=True;steps_per_call=10")):
        marks, window = {}, {}

        def hook(it):
            # steps 11-20: CUDA events; steps 31-40: a trace of the device
            if it in (10, 20):
                marks[it] = torch.cuda.Event(enable_timing=True)
                marks[it].record()
            elif it == 30:
                torch.cuda.synchronize()
                window["prof"] = profile(activities=[ProfilerActivity.CUDA])
                window["prof"].start()
                window["t0"] = time.perf_counter()
            elif it == 40:
                torch.cuda.synchronize()
                window["wall"] = time.perf_counter() - window["t0"]
                window["prof"].stop()

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        save_dir = network_trainer.main(
            [str(REPO / TRAIN_CONFIG), "--device", str(dev), "--exec",
             f"train_set[0]['data_path']='{lif_dir}';save_dir='{out}';run_name='{label}';"
             f"num_epochs=2;max_steps_per_epoch={TRAIN_STEPS};additional_snapshots=[2]"
             f"{extra}"], step_hook=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base   # the run's own, not earlier paths'
        if set(marks) != {10, 20} or "wall" not in window:
            fail(f"train ({label}): the step hook saw {sorted(marks)}, window {sorted(window)}")
        step_ms = marks[10].elapsed_time(marks[20]) / 10
        events = [e for e in window["prof"].profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        busy_us = sum(e.duration_ns() * 1e-3 for e in events)
        idle = 1 - busy_us * 1e-6 / window["wall"]
        recs = [json.loads(l) for l in (save_dir / "logs" / "scalars.jsonl").read_text().splitlines()]
        values = [r.get("scalar", r.get("train")) for r in recs]
        if not values or not all(np.isfinite(v) for v in values):
            fail(f"train ({label}): a logged loss is not finite: {recs}")
        lls = [r["train"] for r in recs if r["tag"] == "epoch_sum/ll"]
        if len(lls) != 2 or not lls[1] < lls[0]:
            fail(f"train ({label}): epoch mean ll {lls} did not fall")
        missing = [f for f in ("hyper.json", "model_2.npz", "encoder_2.npz", "training_2.npz",
                               "optimizer_2.pt") if not (save_dir / f).exists()]
        if missing:
            fail(f"train ({label}): snapshot files missing: {missing}")
        runs[label] = dict(step_ms=step_ms, idle_share=idle, busy_ms_per_step=busy_us * 1e-4,
                           window_ms_per_step=window["wall"] * 100,
                           device_events_per_step=len(events) / 10, peak_gb=peak / 1e9,
                           wall_s=wall, epoch_ll=lls, save_dir=save_dir)
        print(f"train path ({label} sampler): step {step_ms:.3f} ms over steps 11-20 (CUDA "
              f"events); over steps 31-40 the device busy {busy_us * 1e-4:.3f} of "
              f"{window['wall'] * 100:.3f} ms a step in {len(events) / 10:.1f} device events, "
              f"idle share {idle:.4f}; peak memory "
              f"{peak / 1e9:.3f} GB; epoch mean ll {lls}; {wall:.2f} s for the run "
              f"({torch.cuda.get_device_name(0)})", flush=True)

    # the slice's end: the trained checkpoint folded for the kernels
    save_dir = runs["device"]["save_dir"]
    nets, hyper = io.load_model(save_dir / "hyper.json", 2)
    nets.to(dev)
    cfg = parse_config_json(save_dir / "hyper.json")
    ts = cfg.train_set[0]
    ds = LifDataset(ts["data_path"], num_sample=cfg.samples_per_lif,
                    num_surface_sample=ts["num_surface_sample"],
                    augment_rotation=ts["augment_rotation"], augment_noise=ts["augment_noise"])
    dev_ds = DeviceLifDataset(ds, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sdf, surf = dev_ds.sample(torch.arange(64, device=dev), gen)
    enc_p = io.load_params(save_dir / "encoder_2.npz")
    tenc = TrainEncoder(EncoderConfig(cfg.code_length, cfg.encoder_specs["per_point_feat"],
                                      bn=cfg.encoder_specs.get("bn"), mode="cnp"),
                        enc_p["params"], enc_p["bn"]).to(dev).eval()
    tdec = io.load_checkpoint(io.build_model(cfg), save_dir, 2).decoder.to(dev).eval()
    with torch.no_grad():
        lat = nets.encoder(surf.reshape(-1, 6)).reshape(64, -1, cfg.code_length).mean(1)
        x = torch.cat([lat.repeat_interleave(sdf.shape[1], 0), sdf.reshape(-1, 4)[:, :3]], 1)
        enc_x = dev_ds.surf[torch.arange(327680, device=dev) % dev_ds.surf.shape[0]]
        sdf_k, std_k = nets.decoder(x)
        lat_k = nets.encoder(enc_x)
        torch.cuda.synchronize()
        launches_ = read_launches()
        sdf_t, std_t = tdec(x)
        dec_err = max(float((sdf_k - sdf_t).abs().max()), float((std_k - std_t).abs().max()))
        enc_err = float((lat_k - tenc(enc_x)).abs().max())
    print(f"train path: trained checkpoint (epoch 2) through the kernels: decoder_forward on "
          f"{x.shape[0]} rows max abs err {dec_err:.3g}, encoder_forward on {enc_x.shape[0]} "
          f"rows max abs err {enc_err:.3g} against the training modules in eval mode; "
          f"launches {launches_}", flush=True)
    if not (dec_err <= TOL_MLP and enc_err <= TOL_MLP):
        fail(f"train: the trained checkpoint's kernels differ from the training modules "
             f"(decoder {dec_err}, encoder {enc_err}; tolerance {TOL_MLP})")

    # one batch from each sampler (64 LIFs x 4096 samples + 128 surface points)
    idxs = np.arange(64)
    for _ in range(2):
        ds.sample_batch(idxs)
    t0 = time.perf_counter()
    for _ in range(10):
        ds.sample_batch(idxs)
    host_ms = (time.perf_counter() - t0) * 100
    didx = torch.arange(64, device=dev)
    dev_ms = device_ms(lambda: dev_ds.sample(didx, gen))
    dev_call_ms = call_ms(lambda: dev_ds.sample(didx, gen))
    print(f"train path: one batch from the host sampler (LifDataset.sample_batch) "
          f"{host_ms:.3f} ms on the host, from the device sampler {dev_ms:.4f} ms of device "
          f"time ({dev_call_ms:.3f} ms a call between CUDA events); pools "
          f"{dev_ds.nbytes / 1e9:.3f} GB on the card", flush=True)
    res = {k: {kk: vv for kk, vv in v.items() if kk != "save_dir"} for k, v in runs.items()}
    res.update(n_lifs=n_lifs, generate_s=gen_s, host_sampler_ms=host_ms,
               device_sampler_ms=dev_ms, device_sampler_call_ms=dev_call_ms,
               decoder_err=dec_err, encoder_err=enc_err)
    print("train path: " + json.dumps({"train": res}), flush=True)
    return launches_, res


def probe_path(label: str, probe):
    """A probe module (the gather or the frontend probe) through its entry
    point, launch counters zeroed."""
    import torch

    torch.cuda.synchronize()
    zero_launches()
    res = probe.main()
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"{label} probe path: launches {launches}", flush=True)
    return launches, res


def check_launches(paths: dict):
    fusion = ("decoder_forward", "decoder_forward_grad", "encoder_forward",
              "stencil_frontend", "photometric_hg", "gn_step")
    required = {
        "dense": fusion, "lrkt": fusion,
        "fast": fusion + ("select_gather",), "lrkt_fast": fusion + ("select_gather",),
        "scannet_scale": fusion + ("select_gather",),
        "probe": ("row_gather", "row_gather_c1", "lane_gather"),
        "train": ("decoder_forward", "encoder_forward"),
        "frontend_probe": ("stencil_count", "stencil_normals", "stencil_frontend"),
    }
    for label, names in required.items():
        for name in names:
            if paths[label][name] <= 0:
                fail(f"kernel {name} was not launched on the {label} path")
    # the warps gather inside the photometric kernel and the selection in
    # select_gather: the row gather runs on the probe only
    for label in ("dense", "fast", "fpc19", "lrkt", "lrkt_fast", "scannet_scale"):
        if any(paths[label]["row_gather_by_width"].values()):
            fail(f"row_gather ran on the {label} path: {paths[label]['row_gather_by_width']}")
    for c in (1, 2, 4):
        if paths["probe"]["row_gather_by_width"][c] <= 0:
            fail(f"row_gather at width {c} was not launched on the probe path")
    for name in KERNEL_ROWS:
        if sum(p[name] for p in paths.values()) <= 0:
            fail(f"kernel {name} was launched on no path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from nerf_fusion_tpu_torch.ops import cuda_build
    from nerf_fusion_tpu_torch.tools import gather_probe, preprocess_probe

    # cuBLAS's fixed workspace, which PyTorch's deterministic algorithms
    # (the prefetch check) require; set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}; capture into "
          f"a conditional WHILE node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_while_loop_node')}", flush=True)
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)}", flush=True)
    ptxas_report(report)
    tensor_cores = tensor_core_counts()
    rows = kernel_phase(dev)
    paths = {}
    paths["dense"], dense = fusion_path(dev, "dense")
    paths["fast"], _ = fusion_path(dev, "fast", FAST_EXEC)
    # 19 tracking-only frames fill the 20-frame cadence
    paths["fpc19"], block = fusion_path(dev, "fpc19", "frames_per_call=19")
    for key in ("ate_rmse", "mesh_abs_sdf"):
        if not abs(block[key] - dense[key]) <= 3e-4:
            fail(f"frames_per_call = 19: {key} {block[key]} m against the per-frame "
                 f"run's {dense[key]} m")
    paths["probe"], _ = probe_path("gather", gather_probe)
    paths["frontend_probe"], _ = probe_path("frontend", preprocess_probe)
    # the three configs of the data layer, each as its file gives it; the
    # lr-kt configs read the exported room (uint8 / uint16 frames, uploaded
    # ahead on a side stream), scannet-scale renders the large scene
    lrkt_exec = lrkt_export(dev)
    paths["lrkt"], _ = fusion_path(dev, "lrkt", lrkt_exec, LRKT_CONFIG)
    paths["lrkt_fast"], _ = fusion_path(dev, "lrkt_fast", lrkt_exec, LRKT_FAST_CONFIG)
    paths["scannet_scale"], _ = fusion_path(dev, "scannet_scale", None, SCANNET_CONFIG)
    prefetch_check(dev, lrkt_exec)
    paths["train"], _ = train_path(dev)
    check_launches(paths)
    kernels = []
    for r in rows:
        by_path = {label: p[r["name"]] for label, p in paths.items()}
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["err"], "tolerance": r["tol"],
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "bound_peak": ("tf32 tensor cores, 3 passes" if r["name"] in tensor_cores
                           else "f32 CUDA cores" if r["bound"][1] == "operations" else "HBM"),
            **({"bound_f32_ms": r["bound_f32"][0],
                "tensor_core_instructions": tensor_cores[r["name"]]}
               if r["name"] in tensor_cores else {}),
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **{k: r[k] for k in ("grad_err", "grad_tol", "grad_within_tol", "count_err",
                                 "normal_agree_frac", "mask_diff", "pts_equal",
                                 "off_mask_zero", "repeat_equal", "ms_again",
                                 "selection_matches_cpu", "recorded_steps", "cases")
               if k in r}})
    if sorted(k["name"] for k in kernels) != sorted(KERNEL_ROWS):
        fail(f"kernel rows {[k['name'] for k in kernels]} are not {KERNEL_ROWS}")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
