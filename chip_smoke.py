#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels (``nerf_fusion_tpu_torch/csrc/*.cu``, one
   ``nvcc`` per source, in parallel), prints the build time and each
   kernel's registers and spills as ptxas reports them, and counts the
   tensor-core instructions in the compiled code of the two decoder
   variants, the encoder and the decoder's VJP (fails if one has none).
2. Holds every kernel against its plain PyTorch version on the card at
   the shapes of the paths below and times both, and the one PyTorch call
   that computes the same function where there is one: device time from
   a profiler trace (``ms``, ``plain_ms``, ``library_ms``), and the
   kernel's call time between CUDA events (``call_ms``), which includes
   the host's cost of issuing it.  The gathers are held bit-exact, NaN
   positions included, and timed with the L2 flushed before each call (a
   128 MB copy, its own events not counted), so that no row reads faster
   than its bound from device memory; their ragged edges (M not a
   multiple of the row gather's R, an index vector that is not 16-byte
   aligned, a lane row of B % 4 != 0 or of ``LANE_MAX`` lanes, fewer and
   more lane rows than the grid) are held bit-exact too, and ptxas's
   registers and spills are printed for each gather instance;
   ``select_gather`` is held bitwise at the fast path's level-0 selection.
   The photometric kernel's valid count exactly, its H, g and energy to
   1e-4 of each output's largest entry, and two calls bitwise, at the dense
   level-0 shape (stride 2, and stride 1 as ``configs/fusion-lr-kt.yaml``
   runs it) and at the fast path's 24576-pixel selection.  ``gn_step`` on
   every step of a real frame's GN loops (dense and sparse), replayed on
   copies of the recorded state: the new pose within 1e-5 of its largest
   entry, the decisions equal.  The SDF term's ``sdf_rows`` bitwise and
   ``sdf_hg`` (count exactly, H, g, energy within 1e-5) at the GN budget of
   8192 rows on a map of the room.
   ``decoder_vjp`` at the refinement's 327680 rows: dx within 1e-3 of each
   row's largest entry on 99.9 % of the rows, its library call the same VJP
   by autograd over ``decoder_forward_plain``; its line gives ptxas's
   registers and spills (a spill fails the run) and its share of the bound.
   A bound is taken at the peak of the unit the kernel computes on
   (``bound_peak``): the decoders', the VJP's and the encoder's at three
   TF32 tensor-core passes, with the f32 CUDA-core bound beside it
   (``bound_f32_ms``).  The fused frontend stencil is held to the plain
   composition: points bitwise, the final mask pixel for pixel, normals
   by direction on the mask and zero off it, two calls bitwise.  The three
   stencil rows are timed a second time after the photometric phase, with
   the kernel names, grids and the number of device events of each trace
   (``utils.timing.device_trace``): a trace can lose events, and
   ``utils.timing.per_call`` reads such a trace by its mean event.
   The synthetic renderer's batch mode (``render_check``) is held bitwise
   to the single-frame render at 640x480 in both scenes, and a frame timed
   each way.
3. Runs the paths below, each with the launch counters zeroed just before:
   (a) the dense fusion loop through its entry point
       (``nerf_fusion_tpu_torch.main configs/fusion-synth.yaml``, 640x480,
       all 100 frames), each tracked frame after the first as CUDA graph
       replays;
   (b) the fast tracking path: the same with the two deltas of
       ``configs/fusion-lr-kt-fast.yaml`` (``rgb.pixel_budget`` 24576,
       ``mesh_reuse_latent_eps`` 0.003) given by ``--exec``;
   (c) the dense path with ``frames_per_call = 19`` (blocks of 19 frames
       between the 20-frame cadences), held within 0.3 mm of the ATE and
       mesh |SDF| of (a) run again; both runs under PyTorch's
       deterministic algorithms (``index_add_`` atomics make two runs of
       the same path differ otherwise);
   (c2) the dense path with ``--vis 1 --vis_interval 20`` (the previews of
       frames 20, 40, 60 and 80 under ``output/chip_smoke/vis/preview``),
       also under deterministic algorithms: 4 each of ``mesh_*.ply``,
       ``trajectory_*.txt`` and ``blocks_*.ply``, the trajectory at frame 40
       with 41 rows, block wireframes with edges, mesh PLY headers that fit
       their bodies; ATE and mesh |SDF| within 0.3 mm of the deterministic
       dense run's (it prints whether the trajectory is bitwise that run's)
       and the ``vis_preview`` stage ms;
   (c3) the map's debug visuals (``visuals``) and the LM point tracker
       (``lm``) on a fusion-synth pipeline of 41 frames at 640x480:
       ``get_map_visuals`` with blocks, samples, uncertainty and mesh at
       ``voxel_resolution`` 8 (its device ms; the samples within 1e-4 of
       ``decoder_forward_plain`` on the same rows; the live mesher's
       updated-slot accumulators bitwise kept), then ``track_points_lm``
       on the last keyframe's world points (at most 4096) seen under a
       known pose error, 25 iterations under ``torch.cuda.set_sync_debug_mode
       ("error")``: within 1 cm and 1 degree of the truth, within 1 mm and
       0.05 degree of the same run with the plain decoder, one
       ``decoder_forward_grad`` and one ``decoder_forward`` an iteration, ms
       an iteration between CUDA events; then the decoder's ``tp`` layout
       over two NCCL ranks (``tools/tp_check``) where the host has two
       cards (skipped, and said so, with one);
   (c1) the fusion loop's options on fusion-synth (``OPTION_EXECS``), each
       with the dense path's gates: ``refine`` (``do_optimize``: per
       refinement its eligible and sampled voxels, device ms and the mean
       NLL of the first and last Adam step; ``decoder_vjp`` launches =
       refinements x ``optim_n_iters``; fails if no voxel is refined; then
       one refinement on its final map through the ``decoder_vjp`` kernel,
       through ``decoder_vjp_plain`` in f32, in one-pass TF32 and in
       float64, under deterministic algorithms: the kernel's latents within
       ``TOL_REFINE_LAT`` of the float64 run's on at most ``TOL_REFINE_SHARE``
       fewer of the eligible entries than the f32 plain run's, its NLL a step
       within ``TOL_REFINE_NLL``; the TF32 run, the control, must fail that
       gate),
       ``mesh_fast`` (triangles within 20 % of (a)'s, mesh ms beside (a)'s,
       the cadence mesh's slowest call apart, and the final map re-meshed
       whole with either decode, three times alternated),
       ``async`` (``run_async`` and ``do_optimize``: extractions started and
       returned, refinements dispatched and merged, all > 0; each stream's
       busy ms and its overlap with the main stream's kernels; track ms
       beside (a)'s) and ``hash_box`` (the fast path's deltas and
       ``preprocess.box_filter_exact: false``: drop at most 0.05, the JAX
       pipeline's warning level; ``preprocess_frame`` device ms with either
       filter);
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
   (h) ``configs/fusion-scannet-scale.yaml``: the large scene, the first
       300 of its 400 frames (``SCANNET_FRAMES``, cut to keep the script's
       time), map capacity 65536, 4 M triangles;
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
       files exist;
   (j) the per-scene trainer (``scene_path``) through
       ``nerf_fusion_tpu_torch.scene_trainer`` on ``configs/train_scannet.yaml``
       at its full width: the 640x480 room, 100 frames, a keyframe every
       fifth through ``stencil_frontend`` (launches = keyframes), LIFs
       harvested on the host, two epochs of 20 steps of 64 LIFs x 2048
       samples; harvest seconds, keyframes, points, LIFs, the largest
       box-filter drop, step time, busy time and idle share, the epoch ll
       falling, the trained checkpoint through the MLP kernels within 1e-4;
   (k) data parallelism (``dp_path``): ``network_trainer --dp 1`` (one rank,
       NCCL) on the train path's LIFs against the same run without
       ``--dp``, two epochs of 10 steps with dropout: snapshots bitwise,
       logs equal, the group's backend and both step times;
   (l) the model layer (``model_layer_phase``): each image encoder at its
       default widths (spatial, ResNet-18, ResNet-34, image, conv) on a
       (2, 3, 480, 640) batch against the same module on the CPU (f32,
       within 1e-4 of the largest output; the error with cuDNN's TF32 on
       printed beside it), ``gen_rays`` at 640x480 against the CPU, and
       ``chunked_apply`` of ``decoder_forward`` over 2^20 + 5 rows against
       one call, each with its device ms.
   Each fusion path runs in a profiler trace and prints its graph replays,
   host reads and kernels (from the trace) per frame, and its ATE, mesh
   |SDF| (for the lr-kt export against the room's SDF), box-filter drop,
   voxels allocated and triangles; its launch counters must equal this
   repo's kernels in the trace, and each GN group's evaluation through its
   captured graph must give H, g and energy bitwise equal to the same
   functions run eagerly; each evaluation graph must hold the port's
   kernels alone (``tracker.graph_nodes.g<k>``: 2 for an rgb-only group, 5
   for an SDF-plus-rgb one), and ``sdf_rows`` = ``sdf_hg`` =
   ``decoder_forward_grad`` launches.  Two checks besides: ``preprocess_frame`` on a raw
   lr-kt frame bitwise equal to the frame converted on the host, and the
   first 41 frames of (g) with the frames uploaded ahead bitwise equal to
   a run without a prefetcher (both under PyTorch's deterministic
   algorithms).  Fails unless every kernel launched on some path, the
   photometric kernel, the fused frontend stencil and ``gn_step`` on the
   fusion paths, ``decoder_vjp`` on ``refine`` and ``async``, ``select_gather`` on (b), (g) and (h),
   the decoder on (c3)'s visuals and both decoder variants on its LM run, the row gather on no
   fusion path and at 1, 2 and 4 on (d), the two standalone stencils on
   (e), the decoder and the encoder on (i) and (j), ``stencil_frontend``
   on (j), the decoder on (l), and on every fusion path but ``hash_box`` the
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
import shutil
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
SCANNET_FRAMES = 300    # of the config's 400: the first three quarters of the figure-eight
TRAIN_DATA_CONFIG = "configs/data-simple.yaml"
TRAIN_CONFIG = "configs/train-cnp.yaml"
TRAIN_SHAPES = 4        # of the config's 40: about 2700 LIFs
TRAIN_STEPS = 20        # per epoch, two epochs
SCENE_CONFIG = "configs/train_scannet.yaml"
SCENE_FRAMES = 100      # the config's sequence; every fifth a keyframe
SCENE_STEPS = 20        # per epoch, two epochs
DP_STEPS = 10           # per epoch, two epochs
# The fusion loop's options, each on fusion-synth (--exec deltas)
OPTION_EXECS = {
    "refine": "do_optimize=True",
    "mesh_fast": "mesh_fast=True",
    "async": "run_async=True;do_optimize=True",
    "hash_box": FAST_EXEC + ";tracking['preprocess']={'box_filter_exact': False}",
}
TRACE_RERUNS = 2       # more runs of a fusion path whose trace lost kernel records
HASH_DROP_MAX = 0.05    # the JAX pipeline's warning level (nerf_fusion_tpu/system/pipeline.py:215-220)
# (ATE, mesh |SDF|) gates in metres per fusion path; lr-kt's are the JAX
# bench's (bench.py: parity 20 / 28 mm, fast 12 / 20 mm)
GATES = {"dense": (0.02, 0.02), "fast": (0.02, 0.02), "dense_det": (0.02, 0.02),
         "fpc19": (0.02, 0.02), "refine": (0.02, 0.02), "mesh_fast": (0.02, 0.02),
         "async": (0.02, 0.02), "hash_box": (0.02, 0.02),
         "lrkt": (0.02, 0.028), "lrkt_fast": (0.012, 0.02), "scannet_scale": (0.02, 0.02),
         "vis": (0.02, 0.02)}
VIS_ARGV = ["--vis", "1", "--vis_interval", "20"]
VIS_FRAMES = (20, 40, 60, 80)   # the previews of 100 frames at vis_interval 20
VISUALS_FRAMES = 41     # the visuals and LM phases' fusion-synth pipeline
LM_XI = [0.02, -0.015, 0.02, 0.015, -0.02, 0.01]   # tests/test_lm_tracker.py's pose error
LM_ITERS = 25
LM_POINTS = 4096
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
# The decoder's VJP per row: the forward recompute (the four hidden layers
# on the tensor cores, the two heads in f32) and the reverse pass (the
# heads' gradient into lin3's output in f32, then lin3, lin2, lin1 and lin0
# transposed on the tensor cores).
DECODER_VJP_MACS = (DECODER_TC_MACS + 2 * 128) + (2 * 128 + 128 * 128 + 96 * 128
                                                  + 128 * 128 + 128 * 32)
# The encoder's four layers, all on the tensor cores, MACs per row (the
# function's: the kernel's zero padding of K 6 -> 8 and N 29 -> 32 is not
# counted).
ENCODER_MACS = 6 * 32 + 32 * 64 + 64 * 256 + 256 * 29
# The photometric term per evaluated pixel (the warp: three rows of 2 mul
# + 2 add, a mul and an add, two divisions, two roundings) and per valid
# pixel (the Jacobian, the weight, 21 + 6 + 1 multiply-adds of the sums).
PHOTO_OPS_PIXEL = 24
PHOTO_OPS_VALID = 96
# The SDF term around the decoder per row: sdf_rows' two point transforms,
# the voxel lookup and the gate (about 60 operations); sdf_hg's residual,
# Jacobian, weight and 21 + 6 + 1 + 1 sums (about 120).
SDF_ROWS_OPS = 60
SDF_HG_OPS = 120
TOL_SDF_HG = 1e-5       # sdf_hg's H, g, energy: of each output's largest |entry|
TOL_MLP = 1e-4          # decoder / encoder outputs: f32, summation order only
TOL_HG = 1e-4           # photometric H, g, energy: of each output's largest |entry|
TOL_GRAD = 1e-3         # decoder input gradient
TOL_VJP = 1e-3          # decoder VJP: of each row's largest |entry|, on 99.9 % of the rows
# One refinement through the VJP kernel against the same one through the
# plain VJP in float64: the share of eligible latent entries within 1e-4 at
# most 0.1 % below the f32 plain VJP's share (Adam steps by about lr g / |g|,
# so an entry whose gradient is near 0 moves by up to lr a step on a rounding
# difference, in any f32 VJP), the mean NLL at each Adam step within 1e-5
# relative.  A one-pass TF32 VJP must fail it.
TOL_REFINE_LAT = 1e-4
TOL_REFINE_SHARE = 1e-3
TOL_REFINE_NLL = 1e-5
TOL_NORMAL_DOT = 0.999  # |n . n_plain| on 99 % of the valid pixels
TOL_GN = 1e-5           # gn_step's new pose: of its largest |entry| (f32 LU, another library)
TOL_ENC = 1e-4          # image encoders, card vs CPU: of the output's largest |entry| (f32)
TOL_RAYS = 1e-5         # gen_rays, card vs CPU (f32 multiply-adds, unit directions)


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
    row_edges, lane_edges = gather_edges(dev, rng)
    rows = [
        dict(name="row_gather", err=max(dense["err"], probe["err"], select["err"],
                                        *row_edges.values()), tol=0.0,
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
                                 ("selection_c4", select))],
             edge_cases=row_edges),
        dict(name="row_gather_c1", err=single["err"], tol=0.0,
             source="nerf_fusion_tpu_torch/csrc/gather.cu",
             replaces="tools/gather_exp3.py:115 (pallas_gather1)", shape=single["shape"],
             ms=single["ms"], call_ms=single["call_ms"], plain_ms=single["plain_ms"],
             bound=single["bound"], library_ms=single["library_ms"]),
        dict(name="lane_gather", err=max(lane["err"], *lane_edges.values()), tol=0.0,
             source="nerf_fusion_tpu_torch/csrc/gather.cu",
             replaces="tools/gather_exp4.py:72 (lane_gather)", shape=lane["shape"],
             ms=lane["ms"], call_ms=lane["call_ms"], plain_ms=lane["plain_ms"],
             bound=lane["bound"], library_ms=lane["library_ms"], edge_cases=lane_edges),
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
                 ("select_gather", fused), ("row_gather_c1", single), ("lane_gather", lane)):
        if not v["err"] <= 0.0:
            fail(f"{k} differs from its plain version: {v['err']}")
    for k, err in {**row_edges, **lane_edges}.items():
        if not err <= 0.0:
            fail(f"{k} differs from its plain version: {err}")
    print(f"gather edge cases bit-exact, NaN positions included: {sorted(row_edges)} "
          f"{sorted(lane_edges)}", flush=True)
    if not sel_match:
        fail("select_photometric_pixels on the card differs from the CPU's selection")
    return rows


def gather_edges(dev, rng) -> tuple:
    """The gathers' ragged edges, each against its plain version (max abs
    error, inf if the NaN positions differ): the row gather at every width
    with M not a multiple of the plan's R (R = 2 at 307201 rows, and at
    600003 with a second round of the grid-stride loop) and on an index
    vector 1, 2 or 3 indices into an aligned one (``idx[1:]``), NaN rows and
    out-of-range indices in each; the lane gather with B % 4 != 0 and a
    misaligned index vector (rows staged by the block), at B = LANE_MAX, and
    with fewer and more rows than its grid."""
    import numpy as np
    import torch

    from nerf_fusion_tpu_torch.ops import gather

    n = 307200
    rows = {}
    for c in (1, 2, 4):
        r = torch.as_tensor(rng.normal(size=(n,) if c == 1 else (n, c)).astype(np.float32),
                            device=dev)
        r[torch.as_tensor(rng.integers(0, n, 50), device=dev)] = float("nan")
        rows[c] = r
    row_errs = {}
    for c in (1, 2, 4):
        for m, off in ((24577, 0), (76803, 0), (307201, 0), (600003, 0), (24576, 1),
                       (76800, 2), (307200, 3), (600002, 2)):
            full = torch.as_tensor(rng.integers(-100, n + 100, m + off).astype(np.int32),
                                   device=dev)
            idx = full[off:]
            row_errs[f"row_gather_c{c}_m{m}_off{off}"] = nan_err(
                gather.row_gather(rows[c], idx), gather.row_gather_plain(rows[c], idx))
    lane_errs = {}
    for h, b, off in ((37, 3201, 0), (300, 3200, 1), (5, gather.LANE_MAX, 0),
                      (700, gather.LANE_MAX, 0), (7, 3200, 0), (2000, 1280, 0)):
        src = torch.as_tensor(rng.normal(size=(h, b)).astype(np.float32), device=dev)
        src[torch.as_tensor(rng.random((h, b)) < 0.001, device=dev)] = float("nan")
        flat = torch.as_tensor(rng.integers(-b - 3, b + 3, h * b + off).astype(np.int32),
                               device=dev)
        idx = flat[off:].view(h, b)
        lane_errs[f"lane_gather_h{h}_b{b}_off{off}"] = nan_err(
            gather.lane_gather(src, idx), gather.lane_gather_plain(src, idx))
    torch.cuda.synchronize()
    return row_errs, lane_errs


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
    # as the tracker calls it: the kernel forms K dR K^-1 and K dt
    for name, level, st in (("dense", cur, stride), ("sparse", sel, stride),
                            ("dense_stride1", cur, 1)):
        kws = dict(kw, stride=st, K=(K, Kinv))
        args = (rows, level, dR, dt, c.fx, c.fy, c.cx, c.cy)
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


def room_pair(dev, seq, model):
    """Frame 10 integrated into a fresh map at its ground-truth pose and
    frame 11 preprocessed: (map, tracker, pre0, pre1, R0, t0, calib)."""
    import torch

    from nerf_fusion_tpu_torch.system import tracker as T
    from nerf_fusion_tpu_torch.system.map import SparseVoxelMap
    from nerf_fusion_tpu_torch.utils.config import dict_to_args, parse_config_yaml

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
    return vmap, tracker, pre0, pre1, R0, t0, c


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
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    vmap, tracker, pre0, pre1, R0, t0, c = room_pair(dev, seq, model)
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


def sdf_phase(dev, seq, model):
    """The SDF term's two kernels against their plain versions at the GN
    budget of 8192 rows: frame 10 integrated into a fresh map at its
    ground-truth pose, frame 11's points at the true delta pose.
    ``sdf_rows`` bitwise (the decoder input, p_delta, the used rows),
    ``sdf_hg``'s count exactly and H, g, energy within TOL_SDF_HG of each
    output's largest entry, two calls of each bitwise."""
    import torch

    from nerf_fusion_tpu_torch.ops import mlp, sdf_term
    from nerf_fusion_tpu_torch.utils.config import parse_config_yaml
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    sdf = parse_config_yaml(REPO / CONFIG).tracking["sdf"]
    kernel, k = sdf["robust_kernel"], float(sdf["robust_k"])
    vmap, _, _, pre1, R0, t0, _ = room_pair(dev, seq, model)
    f0, f1 = seq.render_frame(10), seq.render_frame(11)
    rel = f0.gt_pose.inv().dot(f1.gt_pose).matrix
    dR = torch.as_tensor(rel[:3, :3], dtype=torch.float32, device=dev).contiguous()
    dt = torch.as_tensor(rel[:3, 3], dtype=torch.float32, device=dev).contiguous()
    cfg, st_, n = vmap.cfg, vmap.state, 8192
    rargs = (pre1.points[:n], pre1.mask[:n], dR, dt, R0.contiguous(), t0, vmap.bound_min,
             cfg.voxel_size, cfg.n_xyz, st_.indexer, st_.obs_count, st_.latents,
             cfg.ignore_count_th)
    rows = sdf_term.sdf_rows(*rargs)
    again = sdf_term.sdf_rows(*rargs)
    plain = sdf_term.sdf_rows_plain(*rargs)
    dec = model.decoder
    out, grad = mlp.decoder_forward_grad(rows[0], dec.packed, dec.mats)
    hargs = (out, grad, rows[1], rows[2], R0.contiguous(), cfg.voxel_size, kernel, k)
    res = sdf_term.sdf_hg(*hargs)
    res_again = sdf_term.sdf_hg(*hargs)
    ref = sdf_term.sdf_hg_plain(*hargs)
    torch.cuda.synchronize()
    rows_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(rows, plain))
    rows_diff = [int((a != b).reshape(n, -1).any(1).sum()) for a, b in zip(rows, plain)]
    hg_err = max(float((res[lo:hi] - ref[lo:hi]).abs().max())
                 / max(float(ref[lo:hi].abs().max()), 1e-30)
                 for lo, hi in ((0, 36), (36, 42), (42, 43)))
    used = int(rows[2].sum())
    print(f"sdf_rows: rows differing from the plain version (x, p_delta, use) {rows_diff}, "
          f"{used} of {n} rows used; sdf_hg: max rel err {hg_err:.3e}, count "
          f"{float(res[43])} / {float(ref[43])}", flush=True)
    if any(rows_diff):
        fail(f"sdf_rows differs from its plain version on rows {rows_diff}")
    if float(res[43]) != float(ref[43]) or used <= 0:
        fail(f"sdf_hg: count {float(res[43])} against the plain version's {float(ref[43])}")
    if not (all(torch.equal(a, b) for a, b in zip(rows, again))
            and torch.equal(res, res_again)):
        fail("sdf_rows or sdf_hg: two calls on the same inputs differ")
    # sdf_rows: 12 + 1 bytes a point in, the indexer entry, the slot's count
    # and latent read (4 + 4 + 116), the decoder row, p_delta and use out
    # (128 + 12 + 1); sdf_hg: out, grad, p_delta and use in (8 + 12 + 12 + 1)
    return [dict(
        name="sdf_rows", err=rows_err, tol=0.0, source="nerf_fusion_tpu_torch/csrc/sdf_term.cu",
        replaces="none (no Pallas source): nerf_fusion_tpu/system/tracker.py _sdf_Hg's point "
                 "transforms and nerf_fusion_tpu/system/map.py get_sdf's lookup, gate and "
                 "decoder input",
        shape=f"({n}, 3) points -> ({n}, 32) + ({n}, 3) + ({n},)",
        ms=device_ms(lambda: sdf_term.sdf_rows(*rargs), 100),
        call_ms=call_ms(lambda: sdf_term.sdf_rows(*rargs), 100),
        plain_ms=device_ms(lambda: sdf_term.sdf_rows_plain(*rargs), 20),
        bound=bound_ms(n * SDF_ROWS_OPS, n * (13 + 124 + 141)), library_ms=None,
        rows_used=used), dict(
        name="sdf_hg", err=hg_err, tol=TOL_SDF_HG,
        source="nerf_fusion_tpu_torch/csrc/sdf_term.cu",
        replaces="none (no Pallas source): nerf_fusion_tpu/system/tracker.py _sdf_Hg's "
                 "residual, Jacobian, robust weight and reductions",
        shape=f"({n}, 2) + ({n}, 3) + ({n}, 3) + ({n},) -> (44,)",
        ms=device_ms(lambda: sdf_term.sdf_hg(*hargs), 100),
        call_ms=call_ms(lambda: sdf_term.sdf_hg(*hargs), 100),
        plain_ms=device_ms(lambda: sdf_term.sdf_hg_plain(*hargs), 20),
        bound=bound_ms(n * SDF_HG_OPS, n * 33 + 44 * 4), library_ms=None,
        count_err=abs(float(res[43]) - float(ref[43])))]


def decoder_vjp_row(dev, dec) -> dict:
    """The decoder's VJP at the refinement's shape (fusion-synth's
    points_capacity 40960 x 8 corner rows): dx within ``TOL_VJP`` of each
    row's largest entry on 99.9 % of the rows (a ReLU input within rounding
    of 0 may take the other side); the library call is the same VJP by
    autograd over ``decoder_forward_plain`` (cuBLAS f32 products)."""
    import torch

    from nerf_fusion_tpu_torch.ops import mlp
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    gen = torch.Generator(device=dev).manual_seed(1)
    n = 8 * 40960
    x = torch.cat([0.3 * torch.randn(n, 29, device=dev, generator=gen),
                   torch.rand(n, 3, device=dev, generator=gen) - 0.5], 1)
    g = torch.randn(n, 2, device=dev, generator=gen)
    dx = mlp.decoder_vjp(x, g, dec.packed, dec.mats)
    ref = mlp.decoder_vjp_plain(x, g, dec.mats)
    torch.cuda.synchronize()
    rel = (dx - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(1e-30)

    def library():
        xr = x.detach().requires_grad_()
        return torch.autograd.grad(mlp.decoder_forward_plain(xr, dec.mats), xr, g)

    nbytes = n * (32 + 2 + 32) * 4 + mlp.DECODER_PACKED * 4
    return dict(
        name="decoder_vjp", err=float((dx - ref).abs().max()), tol=None,
        row_rel_err=float(rel.max()), row_tol=TOL_VJP,
        row_within_tol=float((rel <= TOL_VJP).float().mean()),
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="none (no Pallas source): XLA's reverse-mode autodiff through apply_decoder "
                 "in nerf_fusion_tpu/system/refine.py:79-101",
        shape=f"({n}, 32) + ({n}, 2) -> ({n}, 32)",
        ms=device_ms(lambda: mlp.decoder_vjp(x, g, dec.packed, dec.mats)),
        call_ms=call_ms(lambda: mlp.decoder_vjp(x, g, dec.packed, dec.mats)),
        plain_ms=device_ms(lambda: mlp.decoder_vjp_plain(x, g, dec.mats)),
        library_ms=device_ms(library),
        # f32-exact products as three TF32 tensor-core passes, the unit the
        # kernel runs them on, as for the decoder rows
        bound=bound_ms(3 * 2 * DECODER_VJP_MACS * n, nbytes, PEAK_TF32_FLOPS),
        bound_peak="tf32 tensor cores, 3 passes",
        bound_f32=bound_ms(2 * DECODER_VJP_MACS * n, nbytes))


def ptxas_usage(report: dict, source: str, kernel: str) -> dict:
    """Registers and spill stores and loads (bytes) of ``kernel`` (a substring of its mangled
    name) from ``nvcc -Xptxas=-v``'s report on ``source``; empty where the
    library was already built (no report)."""
    fn, out = "", {}
    for line in report.get(source, {}).get("ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif kernel in fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out["spill_stores"], out["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m.group(1))
    return out


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
    rows += sdf_phase(dev, seq, model)
    rows.append(decoder_vjp_row(dev, dec))
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
        extra = {k: r[k] for k in ("grad_err", "grad_within_tol", "row_rel_err",
                                   "row_within_tol", "normal_agree_frac",
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
    v = next(r for r in rows if r["name"] == "decoder_vjp")
    if v["row_within_tol"] < 0.999:
        fail(f"decoder_vjp: dx within {TOL_VJP} of the row's largest entry on only "
             f"{v['row_within_tol']:.5f} of the rows")
    return rows


KERNEL_ROWS = ("decoder_forward", "decoder_forward_grad", "encoder_forward",
               "stencil_count", "stencil_normals", "stencil_frontend", "row_gather",
               "row_gather_c1", "lane_gather", "photometric_hg", "select_gather", "gn_step",
               "decoder_vjp", "sdf_rows", "sdf_hg")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def vjp_summary(rows: list, report: dict):
    """The decoder VJP's row on one line: ptxas registers and spills, device,
    call, plain and library ms, and its share of the 3xTF32 bound.  Fails if
    ptxas reports a spill."""
    v = next(r for r in rows if r["name"] == "decoder_vjp")
    v.update(ptxas_usage(report, "mlp", "decoder_vjp_kernel"))
    print(f"decoder_vjp: ptxas {v.get('registers', 'not reported (cached build)')} "
          f"registers, spill stores {v.get('spill_stores', 'not reported')} and loads "
          f"{v.get('spill_loads', 'not reported')} bytes; "
          f"{v['ms']:.4f} ms on the device ({v['call_ms']:.4f} ms a call), plain "
          f"{v['plain_ms']:.4f} ms, library {v['library_ms']:.4f} ms; bound "
          f"{v['bound'][0]:.4f} ms on the 3xTF32 tensor cores, share "
          f"{v['bound'][0] / v['ms']:.3f} (f32 CUDA-core bound {v['bound_f32'][0]:.4f} ms); "
          f"rows within {TOL_VJP}: {v['row_within_tol']:.5f} ({card()})", flush=True)
    if v.get("spill_stores", 0) or v.get("spill_loads", 0):
        fail(f"decoder_vjp: ptxas spills {v['spill_stores']} bytes (stores) and "
             f"{v['spill_loads']} (loads); the kernel is budgeted to spill none")


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


def gather_ptxas(report: dict) -> dict:
    """ptxas's registers and spill bytes for each instance of the row gather
    (``row_gather<C, R, vector index>``) and for the lane gather, printed
    on one line; empty where the library was already built."""
    out, fn = {}, ""
    for line in report.get("gather", {}).get("ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            t = re.search(r"row_gather_kernelILi(\d)ELi(\d)ELb(\d)E", fn)
            fn = (f"row_gather<{t.group(1)},{t.group(2)},{t.group(3)}>" if t else
                  "lane_gather" if "lane_gather_kernel" in fn else "")
        elif fn:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(fn, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    print(f"gather kernels, ptxas: {json.dumps(out)}", flush=True)
    return out


def tensor_core_counts() -> dict:
    """Tensor-core instructions in each MLP kernel (the two decoder
    instantiations, the encoder and the decoder's VJP): HMMA/HGMMA in the SASS of the built
    library (``cuobjdump -sass``) or, where the toolkit has no cuobjdump,
    mma/wgmma in the PTX of the same source."""
    from nerf_fusion_tpu_torch.ops import cuda_build

    kernels = {"decoder_forward": "decoder_kernelILb0E",
               "decoder_forward_grad": "decoder_kernelILb1E",
               "encoder_forward": "encoder_kernel",
               "decoder_vjp": "decoder_vjp_kernel"}
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


def stream_stats(prof) -> dict:
    """Per CUDA stream of a trace: kernels, this repo's kernels by counter,
    busy ms (the sum of kernel durations) and, for every stream but the main
    one (the one with the most kernels), the ms of its kernels that overlap
    a kernel of the main stream."""
    import bisect

    from torch.autograd import DeviceType

    from nerf_fusion_tpu_torch.ops import launches

    by = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name.startswith(("Memcpy", "Memset")):
            continue
        by.setdefault(e.device_resource_id(), []).append((e.start_ns(), e.end_ns(), name))
    main = max(by, key=lambda k: len(by[k]))
    merged = []
    for a, b, _ in sorted(by[main]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [m[0] for m in merged]
    out = {}
    for sid, evs in by.items():
        overlap = 0
        if sid != main:
            for a, b, _ in evs:
                j = bisect.bisect_left(starts, b) - 1
                while j >= 0 and merged[j][1] > a:
                    overlap += min(b, merged[j][1]) - max(a, merged[j][0])
                    j -= 1
        mine = {}
        for *_, name in evs:
            c = launches.counter_of(name)
            if c:
                mine[c] = mine.get(c, 0) + 1
        out[sid] = dict(main=sid == main, kernels=len(evs), repo_kernels=mine,
                        busy_ms=1e-6 * sum(b - a for a, b, _ in evs),
                        overlap_ms=1e-6 * overlap)
    return out


def traced_run(argv: list) -> tuple:
    """One run of the fusion entry point with ``argv``, launch counters
    zeroed, in a device trace: (pipeline, result, wall s, counters, launches
    by kernel row, the trace's kernels by counter, all its kernels, the
    profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_fusion_tpu_torch import main as entry
    from nerf_fusion_tpu_torch.ops import launches

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
    return pipe, res, wall, counted, launches_, traced, total, prof


def fusion_path(dev, label: str, exec_: str = None, config: str = CONFIG,
                max_frames: int = None, max_drop: float = 0.0, streams: bool = False,
                after=None, argv: tuple = ()):
    """The fusion loop through its entry point, launch counters zeroed, in a
    profiler trace: the counters must equal the trace's kernels.  Fails on
    the path's ATE and mesh |SDF| gates (``GATES``), a box-filter drop above
    ``max_drop``, a map overflow or an empty mesh.  ``streams``: the trace's
    ``stream_stats`` go into the result.  ``after(pipe, res)`` runs last,
    outside the trace and the counted launches.  ``argv``: more arguments of
    the entry point.

    A trace can lose kernel records (seen under bursts of launches) but
    never gain one, while a counter that counts wrongly does
    so on every run.  So where the trace holds fewer kernels than the
    counters and more of none, the path is run again, up to
    ``TRACE_RERUNS`` times, and the counters of one of those runs must equal
    its trace exactly.  That run gives the launches, the kernels a frame and
    ``stream_stats``; every other gate holds on the first run."""
    import torch

    from nerf_fusion_tpu_torch.data.synth import scene_sdf
    from nerf_fusion_tpu_torch.tools.graph_check import graph_vs_eager
    from nerf_fusion_tpu_torch.utils.evaluate import mesh_abs_sdf_error

    out_dir = REPO / "output" / "chip_smoke" / label
    argv = [str(REPO / config), "--device", str(dev), "--output", str(out_dir), *argv]
    if exec_:
        argv += ["--exec", exec_]
    if max_frames:
        argv += ["--max_frames", str(max_frames)]
    pipe, res, wall, counted, launches_, traced, total, prof = traced_run(argv)
    if "mesh_abs_sdf" not in res:
        # a disk reader has no scene SDF: the lr-kt export is the synthetic
        # room in its own world frame (read with the exported first_tq)
        res["mesh_abs_sdf"] = mesh_abs_sdf_error(pipe.mesher.current_mesh(), scene_sdf,
                                                 device=dev)
    for rerun in range(TRACE_RERUNS):
        if traced == counted or any(traced[k] > counted[k] for k in counted):
            break
        lost = {k: counted[k] - traced[k] for k in counted if counted[k] != traced[k]}
        print(f"{label} path: the trace lost kernel records {lost}; run {rerun + 2} of the "
              f"path to hold the counters to a whole trace", flush=True)
        *_, counted, launches_, traced, total, prof = traced_run(argv)
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
    if not res["box_filter_drop_frac"]["max"] <= max_drop:
        fail(f"{label}: box filter dropped points: {res['box_filter_drop_frac']} "
             f"(at most {max_drop})")
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
    # each evaluation graph holds the port's kernels alone: three for the SDF
    # term, one a photometric level, and gn_step; under deterministic
    # algorithms PyTorch also fills each buffer the capture allocates (one
    # kernel a buffer), so there the port's launches are a part of the nodes
    graphs = tr._step.graphs["iteration"]
    nodes = [g.nodes for g in graphs]
    ours = [sum(g.launches.values()) for g in graphs]
    want = [sum(3 if t[0] == "sdf" else 1 for t in terms) + 1
            for _, terms in tr.tcfg.iter_config]
    counted = {k: v for k, v in res["counters"].items() if k.startswith("tracker.graph_nodes")}
    print(f"{label} path: evaluation graphs' kernel nodes {nodes}, the port's launches "
          f"{ours} (stats.json {counted})", flush=True)
    filled = torch.are_deterministic_algorithms_enabled()
    if ours != want or (any(n < o for n, o in zip(nodes, ours)) if filled else nodes != ours):
        fail(f"{label}: evaluation graphs hold {nodes} kernel nodes and {ours} launches of "
             f"the port, {want} expected: {[g.launches for g in graphs]}")
    # one evaluation of each group through its graph and eagerly, bitwise
    for group in range(len(tr.tcfg.iter_config)):
        got, ref = graph_vs_eager(tr, group)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{label}: group {group}'s captured evaluation differs from the eager "
                 f"one: {[float((a - b).abs().max()) for a, b in zip(got, ref)]}")
    print(f"{label} path: launch counters equal the trace's kernels; H, g, energy of each "
          f"group's captured evaluation bitwise equal to the eager call", flush=True)
    res["wall_s"] = wall
    res["optim_n_iters"] = pipe.map.optim_n_iters
    if streams:
        res["streams"] = stream_stats(prof)
    if after is not None:
        after(pipe, res)
    return launches_, res


def refine_vs_plain(pipe, res):
    """``after`` hook of the refine path: one refinement (the map's Adam
    steps) on the final map with every allocated voxel eligible (no count
    threshold, none optimized yet), at the last frame's points in the world
    frame (the path's shape: its point budget x 8 corner rows), run four
    times under deterministic algorithms, so that only the VJP differs:
    through the ``decoder_vjp`` kernel, through ``decoder_vjp_plain`` in f32,
    in one-pass TF32 (the control: a VJP of lower precision) and in float64
    (the forward kernel each time).  Also the first Adam step's latent
    gradient through each VJP on the same targets, each sampled voxel's row
    against the float64 one's.  The latents, the NLL a step, the gradient
    rows and each run's ms (CUDA events) into ``res["refine_vs_plain"]``."""
    import torch

    from nerf_fusion_tpu_torch.ops import mlp
    from nerf_fusion_tpu_torch.system import refine

    vmap, dec = pipe.map, pipe.map.model.decoder
    mats64 = [(w.double(), b.double()) for w, b in dec.mats]

    def plain_decoder(kind: str):
        class PlainVjp(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return mlp.decoder_forward(x, dec.packed, dec.mats)

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                if kind == "f64":
                    return mlp.decoder_vjp_plain(x.double(), g.double(), mats64).float()
                torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
                try:
                    return mlp.decoder_vjp_plain(x, g.contiguous(), dec.mats)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False

        class PlainVjpDecoder:
            @staticmethod
            def differentiable(x):
                return PlainVjp.apply(x.contiguous())

        return PlainVjpDecoder

    pts, nrm, mask = pipe.tracker.last_processed_pc
    R, t = pipe.tracker.all_pd_pose[-1]
    pts, nrm = pts @ R.T + t[None, :], nrm @ R.T
    state = vmap.state._replace(optimized=torch.zeros_like(vmap.state.optimized))
    cfg = vmap.cfg._replace(encoder_count_th=0.0)
    gt = refine.draw_jitter(pts.shape[0], torch.Generator(device=pts.device).manual_seed(5),
                            pts.device)
    runs = (("kernel", dec), ("plain", plain_decoder("f32")), ("tf32", plain_decoder("tf32")),
            ("f64", plain_decoder("f64")))
    out, ms, grad = {}, {}, {}
    with deterministic():
        for name, d in runs:
            log = {}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = refine.refine_latents_core(state, cfg, d, pts, nrm, mask, gt,
                                           n_iters=vmap.optim_n_iters,
                                           code_reg_lambda=vmap.code_reg_lambda, log=log)
            end.record()
            end.synchronize()
            ms[name] = start.elapsed_time(end)
            out[name] = (r.latents, r.refined, log["nll"], int(log["sampled"]))
        tg = refine.refine_targets(state, cfg, pts, nrm, mask, gt)
        for name, d in runs:
            lat = state.latents.clone().requires_grad_()
            with torch.enable_grad():
                loss, _ = refine.refine_loss(lat, d, tg, vmap.code_reg_lambda)
                (grad[name],) = torch.autograd.grad(loss, lat)
    el, sampled = out["kernel"][1], out["kernel"][3]
    if not sampled:
        fail("refine: no eligible voxel has a sample in the refinement held against the "
             "plain VJP")
    hit = torch.zeros(cfg.latent_capacity + 1, dtype=torch.bool, device=pts.device)
    hit[torch.where(tg.weight > 0, tg.slot, cfg.latent_capacity)] = True
    rows = hit[:-1] & tg.eligible
    ref_lat, ref_nll, ref_grad = out["f64"][0], out["f64"][2], grad["f64"][rows].double()

    def held(name):
        lat, _, nll, _ = out[name]
        diff = (lat - ref_lat)[el].abs()
        rel = ((grad[name][rows].double() - ref_grad).abs().amax(1)
               / ref_grad.abs().amax(1).clamp_min(1e-30))
        return dict(lat_within=float((diff <= TOL_REFINE_LAT).float().mean()),
                    lat_max=float(diff.max()),
                    nll_rel=float((nll - ref_nll).abs().max() / ref_nll.abs().max()),
                    grad_rel_median=float(rel.median()), grad_rel_max=float(rel.max()),
                    grad_within={f"{tol:g}": float((rel <= tol).double().mean())
                                 for tol in (1e-6, 1e-5, 1e-4, 1e-3)})

    res["refine_vs_plain"] = dict(
        eligible=int(el.sum()), sampled=sampled, grad_rows=int(rows.sum()),
        rows=8 * pts.shape[0], steps=vmap.optim_n_iters, ms=ms,
        **{name: held(name) for name in ("kernel", "plain", "tf32")})


def remesh_ms(pipe, res, reps: int = 3):
    """The run's final map re-meshed whole (``no_cache``) with the full and
    the fast decode, alternated ``reps`` times: ms a call (host clock,
    synchronised before and after) and triangles, into ``res``."""
    import torch

    a = pipe.args
    ms, tris = {False: [], True: []}, {}
    for _ in range(reps):
        for fast in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = pipe.mesher.extract(a.resolution, max_std=getattr(a, "max_std", 0.15),
                                    fast=fast, no_cache=True)
            torch.cuda.synchronize()
            ms[fast].append(1e3 * (time.perf_counter() - t0))
            tris[fast] = len(v)
    res["remesh_ms"], res["remesh_tris"] = ms, tris


def render_check(dev):
    """The synthetic renderer's batch mode on the card (an iterated sequence
    renders ``RENDER_BATCH`` frames a pass) against the single-frame render,
    bitwise with NaN depth at the same pixels, for both scenes at 640x480
    (fusion-synth's and fusion-scannet-scale's first 17 frames), and the ms
    of a frame each way (host clock over those frames, synchronised)."""
    import torch

    from nerf_fusion_tpu_torch.data import synth

    n = 2 * synth.RENDER_BATCH + 1
    for scene, length in (("room", 100), ("large", 400)):
        seq = synth.SyntheticSequence(n_frames=length, width=640, height=480, scene=scene,
                                      device=dev)
        seq.render_frame(0)
        ms, frames = {}, {}
        for way, fn in (("batch", lambda i: next(seq)), ("single", seq.render_frame)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames[way] = [fn(i) for i in range(n)]
            torch.cuda.synchronize()
            ms[way] = 1e3 * (time.perf_counter() - t0) / n
        for i, (a, b) in enumerate(zip(frames["batch"], frames["single"])):
            for x, y in ((a.rgb, b.rgb), (a.depth, b.depth)):
                if not (torch.equal(torch.isnan(x), torch.isnan(y))
                        and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))):
                    fail(f"render {scene}: frame {i} of a batch differs from its "
                         f"single-frame render")
        print(f"render {scene}: frames 0-{n - 1} of batches of {synth.RENDER_BATCH} bitwise "
              f"equal to single-frame renders; {ms['batch']:.3f} ms a frame in batches, "
              f"{ms['single']:.3f} ms one by one ({torch.cuda.get_device_name(0)})",
              flush=True)


def option_paths(dev, paths: dict, dense: dict):
    """The fusion loop's options on fusion-synth (``OPTION_EXECS``), each
    through the entry point with the dense path's gates, beside the dense
    run ``dense``: refinement, the fast mesh decode, async meshing and
    refinement, the hash box filter."""
    import torch

    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.system.frontend import preprocess_frame
    from nerf_fusion_tpu_torch.utils.timing import device_ms

    def stage(res, name):
        return res["timing"][name]["mean_ms"] if name in res["timing"] else float("nan")

    def refinements(label, res):
        ref = res.get("refine", [])
        for i, r in enumerate(ref):
            print(f"{label} path: refinement {i}: {r['eligible']} eligible voxels refined, "
                  f"{r['sampled']} with samples, {r['ms']:.3f} ms on the device (CUDA events), "
                  f"mean NLL {r['nll_first']:.5f} at the first Adam step, "
                  f"{r['nll_last']:.5f} at the last", flush=True)
        want = len(ref) * res["optim_n_iters"]
        if paths[label]["decoder_vjp"] != want:
            fail(f"{label}: {paths[label]['decoder_vjp']} decoder_vjp launches, not "
                 f"{len(ref)} refinements x {res['optim_n_iters']} Adam steps")
        if sum(r["eligible"] for r in ref) == 0:
            fail(f"{label}: no voxel was refined over the run")
        return ref

    paths["refine"], res = fusion_path(dev, "refine", OPTION_EXECS["refine"],
                                       after=refine_vs_plain)
    refinements("refine", res)
    rp = res["refine_vs_plain"]
    pl = rp["plain"]
    print(f"refine path: one refinement on the final map ({rp['eligible']} eligible voxels, "
          f"{rp['sampled']} with samples, {rp['rows']} rows, {rp['steps']} Adam steps, "
          f"deterministic algorithms) against the same one through decoder_vjp_plain in "
          f"float64, {rp['ms']['kernel']:.3f} ms through the kernel, {rp['ms']['plain']:.3f} "
          f"ms through the f32 plain VJP (CUDA events):", flush=True)
    for name, what in (("kernel", "the kernel"), ("plain", "the f32 plain VJP"),
                       ("tf32", "the one-pass TF32 plain VJP (control)")):
        h = rp[name]
        print(f"  through {what}: latents within {TOL_REFINE_LAT} on {h['lat_within']:.6f} of "
              f"the eligible entries (at most {h['lat_max']:.3e} apart), mean NLL a step "
              f"within {h['nll_rel']:.3e} relative; the first step's latent gradient "
              f"{h['grad_rel_median']:.3e} from float64's (median of {rp['grad_rows']} "
              f"sampled rows, of each row's largest entry), within 1e-4 on "
              f"{h['grad_within']['0.0001']:.6f}", flush=True)

    def held(h):
        return (h["lat_within"] >= pl["lat_within"] - TOL_REFINE_SHARE
                and h["nll_rel"] <= TOL_REFINE_NLL)

    if not held(rp["kernel"]):
        fail(f"refine: the refinement through the kernel is further from the float64 VJP's "
             f"than the f32 plain VJP's: {rp}")
    if held(rp["tf32"]):
        fail(f"refine: the gate passes the one-pass TF32 VJP, so it cannot judge the "
             f"kernel's precision: {rp}")

    paths["mesh_fast"], res = fusion_path(dev, "mesh_fast", OPTION_EXECS["mesh_fast"],
                                          after=remesh_ms)
    ratio = abs(res["n_triangles"] - dense["n_triangles"]) / dense["n_triangles"]
    print(f"mesh_fast path: {res['n_triangles']} triangles against the dense path's "
          f"{dense['n_triangles']} ({100 * ratio:.2f} % apart); mesh {stage(res, 'mesh'):.3f} "
          f"ms and final mesh {stage(res, 'final_mesh'):.3f} ms a call against the dense "
          f"path's {stage(dense, 'mesh'):.3f} and {stage(dense, 'final_mesh'):.3f} ms",
          flush=True)
    for label, r in (("mesh_fast", res), ("dense", dense)):
        m = r["timing"]["mesh"]
        print(f"mesh_fast path: the {label} path's cadence mesh: {m['count']} calls, mean "
              f"{m['mean_ms']:.3f} ms, the slowest {m['max_ms']:.3f} ms, the others' mean "
              f"{(1e3 * m['total_s'] - m['max_ms']) / max(m['count'] - 1, 1):.3f} ms",
              flush=True)
    rm = res["remesh_ms"]
    print(f"mesh_fast path: the final map re-meshed whole, alternated: full decode "
          f"{[round(x, 3) for x in rm[False]]} ms ({res['remesh_tris'][False]} triangles), "
          f"fast decode {[round(x, 3) for x in rm[True]]} ms ({res['remesh_tris'][True]} "
          f"triangles) ({torch.cuda.get_device_name(0)})", flush=True)
    if not ratio < 0.2:
        fail(f"mesh_fast: triangle count {res['n_triangles']} not within 20 % of "
             f"{dense['n_triangles']}")

    paths["async"], res = fusion_path(dev, "async", OPTION_EXECS["async"], streams=True)
    ref = refinements("async", res)
    am = res["async_mesh"]
    print(f"async path: extractions started {am['started']}, returned {am['returned']}; "
          f"refinements dispatched {len(ref)}, merged {res['refine_merged']}; track "
          f"{stage(res, 'track'):.3f} ms a frame against the dense path's "
          f"{stage(dense, 'track'):.3f}", flush=True)
    if min(am["started"], am["returned"], len(ref), res["refine_merged"]) <= 0:
        fail(f"async: extractions {am}, refinements dispatched {len(ref)}, merged "
             f"{res['refine_merged']}")
    # the workers' streams: this repo's kernels off the main stream, without
    # the photometric kernel (the tracker's warm-up stream has it)
    for sid, st in sorted(res["streams"].items(), key=lambda kv: -kv[1]["kernels"]):
        role = ("main" if st["main"] else "worker" if st["repo_kernels"]
                and "photometric_hg" not in st["repo_kernels"] else "other")
        print(f"async path: stream {sid} ({role}): {st['kernels']} kernels, busy "
              f"{st['busy_ms']:.3f} ms, overlapping main-stream kernels "
              f"{st['overlap_ms']:.3f} ms, this repo's kernels {st['repo_kernels']}",
              flush=True)

    paths["hash_box"], res = fusion_path(dev, "hash_box", OPTION_EXECS["hash_box"],
                                         max_drop=HASH_DROP_MAX)
    drop = res["box_filter_drop_frac"]
    fr = SyntheticSequence(n_frames=100, width=640, height=480, device=dev).render_frame(10)
    c = fr.calib
    pre_ms = {exact: device_ms(lambda: preprocess_frame(
        fr.rgb, fr.depth, c.fx, c.fy, c.cx, c.cy, 0.5, 5.0, 40960, box_filter_exact=exact))
        for exact in (True, False)}
    print(f"hash_box path: box-filter drop mean {drop['mean']:.6f}, max {drop['max']:.6f} "
          f"(at most {HASH_DROP_MAX}); preprocess_frame on a 640x480 frame "
          f"{pre_ms[False]:.4f} ms on the device with the hash filter, {pre_ms[True]:.4f} "
          f"with the exact one", flush=True)


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


class StepProbe:
    """A trainer's ``step_hook``: CUDA events at steps ``events`` (the step
    time between them) and a device trace over steps ``trace`` (busy time,
    device events and idle share a step); ``trace=None`` takes none."""

    def __init__(self, events=(10, 20), trace=(30, 40)):
        self.events, self.trace = events, trace
        self.marks, self.window = {}, {}

    def __call__(self, it):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if it in self.events:
            self.marks[it] = torch.cuda.Event(enable_timing=True)
            self.marks[it].record()
        if self.trace and it == self.trace[0]:
            torch.cuda.synchronize()
            self.window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            self.window["prof"].start()
            self.window["t0"] = time.perf_counter()
        elif self.trace and it == self.trace[1]:
            torch.cuda.synchronize()
            self.window["wall"] = time.perf_counter() - self.window["t0"]
            self.window["prof"].stop()

    def result(self, label: str) -> dict:
        from torch.autograd import DeviceType

        a, b = self.events
        if set(self.marks) != {a, b} or (self.trace and "wall" not in self.window):
            fail(f"{label}: the step hook saw {sorted(self.marks)}, window "
                 f"{sorted(self.window)}")
        out = dict(step_ms=self.marks[a].elapsed_time(self.marks[b]) / (b - a))
        if self.trace:
            n = self.trace[1] - self.trace[0]
            events = [e for e in self.window["prof"].profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA]
            busy_us = sum(e.duration_ns() * 1e-3 for e in events)
            out.update(idle_share=1 - busy_us * 1e-6 / self.window["wall"],
                       busy_ms_per_step=busy_us * 1e-3 / n,
                       window_ms_per_step=self.window["wall"] * 1e3 / n,
                       device_events_per_step=len(events) / n)
        return out


def check_run(label: str, save_dir, epoch: int) -> list:
    """A training run's log and snapshot: every logged loss finite, the
    epoch mean ll falling from epoch to epoch, the snapshot files of
    ``epoch`` there.  Returns the epoch mean lls."""
    import numpy as np

    recs = [json.loads(l) for l in (save_dir / "logs" / "scalars.jsonl").read_text().splitlines()]
    values = [r.get("scalar", r.get("train")) for r in recs]
    if not values or not all(np.isfinite(v) for v in values):
        fail(f"{label}: a logged loss is not finite: {recs}")
    lls = [r["train"] for r in recs if r["tag"] == "epoch_sum/ll"]
    if len(lls) != epoch or not all(b < a for a, b in zip(lls, lls[1:])):
        fail(f"{label}: epoch mean ll {lls} did not fall")
    missing = [f for f in ("hyper.json", f"model_{epoch}.npz", f"encoder_{epoch}.npz",
                           f"training_{epoch}.npz", f"optimizer_{epoch}.pt")
               if not (save_dir / f).exists()]
    if missing:
        fail(f"{label}: snapshot files missing: {missing}")
    return lls


def checkpoint_through_kernels(label: str, dev, save_dir, epoch: int, sdf, surf, enc_x):
    """A trained checkpoint folded by ``load_model`` through ``decoder_forward``
    (the batch's decoder input: (B, M) surface points' mean latents repeated
    per SDF sample of ``sdf`` (B, S, 4)) and ``encoder_forward`` (``enc_x``),
    held within ``TOL_MLP`` of the training modules in eval mode.  The
    launches are read after the kernels and before the comparison.
    Returns (launches, decoder err, encoder err)."""
    import torch

    from nerf_fusion_tpu_torch.models import io
    from nerf_fusion_tpu_torch.models.encoder import EncoderConfig, TrainEncoder
    from nerf_fusion_tpu_torch.utils.config import parse_config_json

    nets, _ = io.load_model(save_dir / "hyper.json", epoch)
    nets.to(dev)
    cfg = parse_config_json(save_dir / "hyper.json")
    enc_p = io.load_params(save_dir / f"encoder_{epoch}.npz")
    tenc = TrainEncoder(EncoderConfig(cfg.code_length, cfg.encoder_specs["per_point_feat"],
                                      bn=cfg.encoder_specs.get("bn"), mode="cnp"),
                        enc_p["params"], enc_p["bn"]).to(dev).eval()
    tdec = io.load_checkpoint(io.build_model(cfg), save_dir, epoch).decoder.to(dev).eval()
    B = sdf.shape[0]
    with torch.no_grad():
        lat = nets.encoder(surf.reshape(-1, 6)).reshape(B, -1, cfg.code_length).mean(1)
        x = torch.cat([lat.repeat_interleave(sdf.shape[1], 0), sdf.reshape(-1, 4)[:, :3]], 1)
        sdf_k, std_k = nets.decoder(x)
        lat_k = nets.encoder(enc_x)
        torch.cuda.synchronize()
        launches_ = read_launches()
        sdf_t, std_t = tdec(x)
        dec_err = max(float((sdf_k - sdf_t).abs().max()), float((std_k - std_t).abs().max()))
        enc_err = float((lat_k - tenc(enc_x)).abs().max())
    print(f"{label} path: trained checkpoint (epoch {epoch}) through the kernels: "
          f"decoder_forward on {x.shape[0]} rows max abs err {dec_err:.3g}, encoder_forward on "
          f"{enc_x.shape[0]} rows max abs err {enc_err:.3g} against the training modules in "
          f"eval mode; launches {launches_}", flush=True)
    if not (dec_err <= TOL_MLP and enc_err <= TOL_MLP):
        fail(f"{label}: the trained checkpoint's kernels differ from the training modules "
             f"(decoder {dec_err}, encoder {enc_err}; tolerance {TOL_MLP})")
    return launches_, dec_err, enc_err


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

    from nerf_fusion_tpu_torch import data_generator, network_trainer
    from nerf_fusion_tpu_torch.data.device_lif import DeviceLifDataset
    from nerf_fusion_tpu_torch.data.lif_dataset import LifDataset
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
        probe = StepProbe()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        save_dir = network_trainer.main(
            [str(REPO / TRAIN_CONFIG), "--device", str(dev), "--exec",
             f"train_set[0]['data_path']='{lif_dir}';save_dir='{out}';run_name='{label}';"
             f"num_epochs=2;max_steps_per_epoch={TRAIN_STEPS};additional_snapshots=[2]"
             f"{extra}"], step_hook=probe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base   # the run's own, not earlier paths'
        runs[label] = dict(probe.result(f"train ({label})"), peak_gb=peak / 1e9, wall_s=wall,
                           epoch_ll=check_run(f"train ({label})", save_dir, 2),
                           save_dir=save_dir)
        r = runs[label]
        print(f"train path ({label} sampler): step {r['step_ms']:.3f} ms over steps 11-20 "
              f"(CUDA events); over steps 31-40 the device busy {r['busy_ms_per_step']:.3f} of "
              f"{r['window_ms_per_step']:.3f} ms a step in {r['device_events_per_step']:.1f} "
              f"device events, idle share {r['idle_share']:.4f}; peak memory "
              f"{peak / 1e9:.3f} GB; epoch mean ll {r['epoch_ll']}; {wall:.2f} s for the run "
              f"({torch.cuda.get_device_name(0)})", flush=True)

    # the slice's end: the trained checkpoint folded for the kernels
    save_dir = runs["device"]["save_dir"]
    cfg = parse_config_json(save_dir / "hyper.json")
    ts = cfg.train_set[0]
    ds = LifDataset(ts["data_path"], num_sample=cfg.samples_per_lif,
                    num_surface_sample=ts["num_surface_sample"],
                    augment_rotation=ts["augment_rotation"], augment_noise=ts["augment_noise"])
    dev_ds = DeviceLifDataset(ds, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sdf, surf = dev_ds.sample(torch.arange(64, device=dev), gen)
    enc_x = dev_ds.surf[torch.arange(327680, device=dev) % dev_ds.surf.shape[0]]
    launches_, dec_err, enc_err = checkpoint_through_kernels("train", dev, save_dir, 2, sdf,
                                                              surf, enc_x)

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
               decoder_err=dec_err, encoder_err=enc_err, lif_dir=str(lif_dir))
    print("train path: " + json.dumps({"train": res}), flush=True)
    return launches_, res


def scene_path(dev):
    """The per-scene trainer through its entry point
    (``nerf_fusion_tpu_torch.scene_trainer``) on ``configs/train_scannet.yaml``
    at its full width: the 640x480 synthetic room, ``SCENE_FRAMES`` frames
    harvested at the config's stride (every fifth frame a keyframe through
    ``stencil_frontend`` and the box filter), then two epochs of
    ``SCENE_STEPS`` steps of 64 LIFs x 2048 samples.  Launch counters
    zeroed before the path; ``stencil_frontend`` must have launched once a
    keyframe.  Prints the harvest (seconds, keyframes, points, LIFs, the
    largest box-filter drop), the step time over steps 11-20 (CUDA events)
    and the device's busy time and idle share over steps 31-40 (a trace);
    fails unless the epoch mean ll falls and the trained checkpoint through
    ``decoder_forward`` / ``encoder_forward`` is within ``TOL_MLP`` of the
    training modules."""
    import shutil

    import torch
    import torch.nn.functional as F

    from nerf_fusion_tpu_torch import scene_trainer

    out = REPO / "output" / "chip_smoke" / "scene"
    shutil.rmtree(out, ignore_errors=True)
    probe = StepProbe()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    save_dir = scene_trainer.main(
        [str(REPO / SCENE_CONFIG), "--device", str(dev), "--max_frames", str(SCENE_FRAMES),
         "--exec", f"save_dir='{out}';num_epochs=2;max_steps_per_epoch={SCENE_STEPS};"
                   "additional_snapshots=[2]"], step_hook=probe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    harvest = json.loads((save_dir / "harvest.json").read_text())
    frontend = read_launches()["stencil_frontend"]
    res = dict(probe.result("scene"), wall_s=wall, epoch_ll=check_run("scene", save_dir, 2),
               harvest_s=harvest["seconds"], keyframes=harvest["keyframes"],
               points=harvest["points"], lifs=harvest["lifs"],
               drop_frac_max=max(harvest["drop_frac"]), stencil_frontend=frontend)
    print(f"scene path: harvest {res['harvest_s']:.2f} s, {res['keyframes']} keyframes, "
          f"{res['points']} surface points, {res['lifs']} LIFs, box-filter drop_frac max "
          f"{res['drop_frac_max']}, stencil_frontend launches {frontend}; step "
          f"{res['step_ms']:.3f} ms over steps 11-20 (CUDA events); over steps 31-40 the "
          f"device busy {res['busy_ms_per_step']:.3f} of {res['window_ms_per_step']:.3f} ms a "
          f"step in {res['device_events_per_step']:.1f} device events, idle share "
          f"{res['idle_share']:.4f}; epoch mean ll {res['epoch_ll']}; {wall:.2f} s for the run "
          f"({torch.cuda.get_device_name(0)})", flush=True)
    if frontend != res["keyframes"]:
        fail(f"scene: {frontend} stencil_frontend launches for {res['keyframes']} keyframes")
    # a batch in the LIF frame: 64 LIFs x 2048 samples and 128 surface points
    gen = torch.Generator(device=dev).manual_seed(0)
    sdf = torch.rand(64, 2048, 4, device=dev, generator=gen) * 2 - 1
    surf = torch.cat([torch.rand(64, 128, 3, device=dev, generator=gen) * 2 - 1,
                      F.normalize(torch.randn(64, 128, 3, device=dev, generator=gen), dim=-1)],
                     -1)
    launches_, res["decoder_err"], res["encoder_err"] = checkpoint_through_kernels(
        "scene", dev, save_dir, 2, sdf, surf, surf.reshape(-1, 6))
    print("scene path: " + json.dumps({"scene": res}), flush=True)
    return launches_, res


def dp_path(dev, lif_dir: str):
    """``network_trainer --dp 1`` (one rank in this process, NCCL on the
    card) against the same run without ``--dp``: ``configs/train-cnp.yaml``
    at full width on the train path's LIFs, 2 epochs of ``DP_STEPS`` steps
    with the config's dropout.  The snapshots must be bitwise equal and the
    logs equal; prints the group's backend and both step times (steps 6-16,
    CUDA events)."""
    import numpy as np
    import torch

    from nerf_fusion_tpu_torch import network_trainer
    from nerf_fusion_tpu_torch.models import io

    out = REPO / "output" / "chip_smoke" / "dp"
    runs, backends = {}, []

    class Probe(StepProbe):
        def __call__(self, it):
            if it == 1:
                backends.append(torch.distributed.get_backend()
                                if torch.distributed.is_initialized() else None)
            super().__call__(it)

    torch.cuda.synchronize()
    zero_launches()
    for label, extra in (("single", []), ("dp1", ["--dp", "1"])):
        probe = Probe(events=(6, 16), trace=None)
        save_dir = network_trainer.main(
            [str(REPO / TRAIN_CONFIG), "--device", str(dev), *extra, "--exec",
             f"train_set[0]['data_path']='{lif_dir}';save_dir='{out}';run_name='{label}';"
             f"num_epochs=2;max_steps_per_epoch={DP_STEPS};additional_snapshots=[2]"],
            step_hook=probe)
        torch.cuda.synchronize()
        runs[label] = dict(probe.result(f"dp ({label})"), save_dir=save_dir,
                           epoch_ll=check_run(f"dp ({label})", save_dir, 2))
    launches_ = read_launches()     # none: training runs PyTorch's kernels
    same = {}
    for part in ("model", "encoder"):
        a, b = (io.flatten(io.load_params(runs[k]["save_dir"] / f"{part}_2.npz"))
                for k in ("single", "dp1"))
        same[part] = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    logs = [(runs[k]["save_dir"] / "logs" / "scalars.jsonl").read_text()
            for k in ("single", "dp1")]
    res = dict(backend=backends[1], single_step_ms=runs["single"]["step_ms"],
               dp1_step_ms=runs["dp1"]["step_ms"], params_bitwise=same,
               logs_equal=logs[0] == logs[1], epoch_ll=runs["dp1"]["epoch_ll"])
    print(f"dp path: --dp 1 in a {res['backend']} group against no group: parameters "
          f"bitwise equal {same}, logs equal {res['logs_equal']}; step "
          f"{res['dp1_step_ms']:.3f} ms with DDP, {res['single_step_ms']:.3f} ms without "
          f"(steps 7-16, CUDA events; {torch.cuda.get_device_name(0)})", flush=True)
    if backends != [None, "nccl"]:
        fail(f"dp: process-group backends {backends}, expected [None, 'nccl']")
    if not (all(same.values()) and res["logs_equal"]):
        fail(f"dp: --dp 1 differs from the run without --dp: {same}, logs equal "
             f"{res['logs_equal']}")
    return launches_, res


def model_layer_phase(dev):
    """The model layer on the card against the same modules and weights on
    the CPU: each image encoder at its default widths on a (2, 3, 480, 640)
    batch (TF32 off, held to ``TOL_ENC`` of the output's largest entry; the
    error with cuDNN's TF32 on is printed beside it), ``gen_rays`` at
    640x480, and ``chunked_apply`` of ``decoder_forward`` over 2^20 + 5 rows
    against one call (launch counters zeroed before it, read after it).
    Prints each one's device ms: for the encoders and ``chunked_apply`` CUDA
    events around back-to-back calls (milliseconds of kernels a call, far
    above the host's issue time; a profiler trace once dropped the
    decoder's kernels of ``chunked_apply``), for ``gen_rays`` (0.06 ms of
    small kernels) the kernels of a profiler trace."""
    import copy

    import torch

    from nerf_fusion_tpu_torch.models import apply, img_encoder as ie
    from nerf_fusion_tpu_torch.models.io import load_model
    from nerf_fusion_tpu_torch.utils import rays
    from nerf_fusion_tpu_torch.utils.timing import call_ms, device_ms

    res = {}
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(2, 3, 480, 640, generator=gen)
    img_d = img.to(dev)
    for name, kind, kw in (("spatial", "spatial", {}), ("resnet18", "resnet", {"depth": 18}),
                           ("resnet34", "resnet", {"depth": 34}), ("image", "global", {}),
                           ("conv", "conv", {})):
        net = ie.make_encoder(kind, gen=torch.Generator().manual_seed(1), **kw).eval()
        net_d = copy.deepcopy(net).to(dev)
        with torch.no_grad():
            ref = net(img)
            out = net_d(img_d)
            torch.backends.cudnn.allow_tf32 = True
            tf32 = net_d(img_d)
            torch.backends.cudnn.allow_tf32 = False
            scale = float(ref.abs().max())
            res[name] = dict(shape=list(out.shape),
                             rel_err=float((out.cpu() - ref).abs().max()) / scale,
                             tf32_rel_err=float((tf32.cpu() - ref).abs().max()) / scale,
                             ms=call_ms(lambda: net_d(img_d), 5))
    R = torch.linalg.qr(torch.randn(3, 3, generator=gen))[0]
    t = torch.randn(3, generator=gen)
    args = (640, 480, 481.2, 481.2, 319.5, 239.5, 0.5, 5.0)
    ref = rays.gen_rays(R, t, *args)
    R_d, t_d = R.to(dev), t.to(dev)
    out = rays.gen_rays(R_d, t_d, *args)
    res["gen_rays"] = dict(shape=list(out.shape), abs_err=float((out.cpu() - ref).abs().max()),
                           ms=device_ms(lambda: rays.gen_rays(R_d, t_d, *args)))
    model, _ = load_model(REPO / "ckpt/default/hyper.json", 300)
    model.to(dev)
    x = torch.cat([0.3 * torch.randn((1 << 20) + 5, 29, generator=gen),
                   torch.rand((1 << 20) + 5, 3, generator=gen) - 0.5], 1).to(dev)
    torch.cuda.synchronize()
    zero_launches()
    chunked = apply.chunked_apply(model.decoder, x)
    torch.cuda.synchronize()
    launches_ = read_launches()
    whole = model.decoder(x)
    res["chunked_apply"] = dict(
        rows=x.shape[0], launches=launches_["decoder_forward"],
        abs_err=max(float((a - b).abs().max()) for a, b in zip(chunked, whole)),
        bitwise=all(torch.equal(a, b) for a, b in zip(chunked, whole)),
        ms=call_ms(lambda: apply.chunked_apply(model.decoder, x), 5))
    for name, r in res.items():
        print(f"model layer: {name} {r} ({torch.cuda.get_device_name(0)})", flush=True)
    for name in ("spatial", "resnet18", "resnet34", "image", "conv"):
        if not res[name]["rel_err"] <= TOL_ENC:
            fail(f"model layer: {name} on the card differs from the CPU by "
                 f"{res[name]['rel_err']} of its largest output (tolerance {TOL_ENC})")
    if not res["gen_rays"]["abs_err"] <= TOL_RAYS:
        fail(f"model layer: gen_rays differs from the CPU by {res['gen_rays']['abs_err']}")
    if not res["chunked_apply"]["abs_err"] <= TOL_MLP:
        fail(f"model layer: chunked_apply differs from one call by "
             f"{res['chunked_apply']['abs_err']}")
    return launches_, res


def keep_poses(pipe, res):
    """``after`` hook: the run's pose log (device) into ``res``."""
    res["pose_log"] = pipe.tracker._pose_log[:pipe.tracker.n_tracked].clone()


def _ply_header(path: Path) -> tuple:
    """(header lines, bytes after the header) of a PLY file."""
    data = path.read_bytes()
    head, sep, body = data.partition(b"end_header\n")
    if not sep:
        fail(f"vis: {path.name} has no end_header")
    return head.decode().splitlines(), body


def vis_check(vis: dict, dense: dict, wall: float):
    """The ``--vis`` run's previews and result beside ``dense_det``'s: 4 of
    each file, the trajectory at frame 40 with 41 rows, block wireframes
    with edges, mesh PLY headers that fit their bodies; ATE and mesh |SDF|
    within 0.3 mm of the run without previews."""
    import numpy as np
    import torch

    prev = REPO / "output" / "chip_smoke" / "vis" / "preview"
    for kind, ext in (("mesh", "ply"), ("trajectory", "txt"), ("blocks", "ply")):
        names = sorted(p.name for p in prev.glob(f"{kind}_*.{ext}"))
        want = [f"{kind}_{i:05d}.{ext}" for i in VIS_FRAMES]
        if names != want:
            fail(f"vis: preview {kind} files {names}, not {want}")
    rows = np.loadtxt(prev / "trajectory_00040.txt").shape
    if rows != (41, 8):
        fail(f"vis: trajectory_00040.txt has shape {rows}, not (41, 8)")
    edges = []
    for i in VIS_FRAMES:
        head, _ = _ply_header(prev / f"blocks_{i:05d}.ply")
        n = [int(l.split()[-1]) for l in head if l.startswith("element edge")]
        if not n or n[0] <= 0:
            fail(f"vis: blocks_{i:05d}.ply has no edges")
        edges.append(n[0])
        head, body = _ply_header(prev / f"mesh_{i:05d}.ply")
        counts = {l.split()[1]: int(l.split()[2]) for l in head if l.startswith("element")}
        size = counts.get("vertex", -1) * 15 + counts.get("face", -1) * 13
        if (head[:2] != ["ply", "format binary_little_endian 1.0"]
                or counts.get("vertex", 0) <= 0 or size != len(body)):
            fail(f"vis: mesh_{i:05d}.ply header {head} does not fit its {len(body)} bytes")
    same = torch.equal(vis["pose_log"], dense["pose_log"])
    t = vis["timing"]["vis_preview"]
    print(f"vis path: previews at frames {list(VIS_FRAMES)} ({t['count']} writes, "
          f"vis_preview mean {t['mean_ms']:.3f} ms, slowest {t['max_ms']:.3f} ms), block "
          f"edges {edges}; ATE {1e3 * vis['ate_rmse']:.4f} mm, mesh |SDF| "
          f"{1e3 * vis['mesh_abs_sdf']:.4f} mm against dense_det's "
          f"{1e3 * dense['ate_rmse']:.4f}, {1e3 * dense['mesh_abs_sdf']:.4f}; trajectory "
          f"bitwise dense_det's: {same}; wall {wall:.2f} s", flush=True)
    if t["count"] != len(VIS_FRAMES):
        fail(f"vis: {t['count']} preview writes, not {len(VIS_FRAMES)}")
    for key in ("ate_rmse", "mesh_abs_sdf"):
        if not abs(vis[key] - dense[key]) <= 3e-4:
            fail(f"vis: {key} {vis[key]} m against dense_det's {dense[key]} m")


class PlainDecoder:
    """The map's decoder through its plain PyTorch versions (on the card,
    for the LM phase's reference run)."""

    def __init__(self, dec):
        self.mats = dec.mats

    def __call__(self, net_in):
        from nerf_fusion_tpu_torch.ops import mlp

        out = mlp.decoder_forward_plain(net_in, self.mats)
        return out[:, 0:1], out[:, 1:2]

    def forward_grad(self, net_in):
        from nerf_fusion_tpu_torch.ops import mlp

        return mlp.decoder_forward_grad_plain(net_in, self.mats)


def _pose_err(R, t, iso) -> tuple:
    """(translation m, rotation degrees) between a device pose and an Isometry."""
    import numpy as np

    from nerf_fusion_tpu_torch.utils.se3 import Isometry

    rec = Isometry.from_matrix(R.double().cpu().numpy(), t.double().cpu().numpy(), ortho=True)
    dR = rec.q.rotation_matrix.T @ iso.q.rotation_matrix
    return (float(np.linalg.norm(rec.t - iso.t)),
            float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))))


def visuals_lm_phase(dev):
    """The map's debug visuals and the LM point tracker on a fusion-synth
    pipeline of ``VISUALS_FRAMES`` frames at 640x480 (through the entry
    point).  Visuals: ``get_map_visuals`` with all four parts at
    ``voxel_resolution`` 8 (counters zeroed; device ms from its trace), the
    samples' sdf and std within 1e-4 of ``decoder_forward_plain`` on the
    same rows, the live mesher's updated-slot accumulators bitwise as
    before.  LM: the last keyframe's world points (at most ``LM_POINTS``,
    strided) seen under ``LM_XI``, ``LM_ITERS`` iterations under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync fails it): the
    pose within 1 cm and 1 degree of the truth and within 1 mm and 0.05
    degree of the same run with the plain decoder; one ``decoder_forward_grad``
    and one ``decoder_forward`` an iteration.
    :return: (visuals launches, lm launches, results)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_fusion_tpu_torch import main as entry
    from nerf_fusion_tpu_torch.ops import mlp
    from nerf_fusion_tpu_torch.system.tracker import track_points_lm
    from nerf_fusion_tpu_torch.utils.se3 import Isometry

    t0 = time.perf_counter()
    pipe, _ = entry.run([str(REPO / CONFIG), "--device", str(dev), "--output",
                         str(REPO / "output" / "chip_smoke" / "visuals"),
                         "--max_frames", str(VISUALS_FRAMES)])
    vmap = pipe.map
    # pending updates for the live mesher (the run's final mesh took them)
    occ = (vmap.state.positions >= 0).cpu().numpy()
    vmap.updated_slots[np.flatnonzero(occ)[::3]] = True
    every2 = torch.zeros_like(vmap.state.positions, dtype=torch.bool)
    every2[::2] = True
    vmap._mark_updated(every2 & (vmap.state.positions >= 0))
    slots_before = vmap.updated_slots.copy()
    dev_before = vmap._updated_dev.clone()
    name = torch.cuda.get_device_name(0)

    torch.cuda.synchronize()
    zero_launches()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = vmap.get_map_visuals(return_blocks=True, return_samples=True,
                                   return_uncertainty=True, return_mesh=True,
                                   voxel_resolution=8)
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t1)
    vis_launches = read_launches()
    busy_ms = 1e-6 * sum(e.end_ns() - e.start_ns() for e in
                         prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA)
    kept = (np.array_equal(vmap.updated_slots, slots_before)
            and torch.equal(vmap._updated_dev, dev_before))
    net_in, sdf, std, pos = vmap.decode_samples(8)
    ref = mlp.decoder_forward_plain(net_in, vmap.model.decoder.mats)
    err = max(float((sdf - ref[:, 0]).abs().max()), float((std - ref[:, 1]).abs().max()))
    n_samples = len(out["samples"][0]["points"])
    print(f"visuals: get_map_visuals (blocks, samples, uncertainty, mesh; voxel_resolution "
          f"8) on {int(vmap.state.n_occupied)} voxels: {n_samples} samples, "
          f"{len(out['mesh'][0])} triangles, {len(out['blocks'][0]['lines'])} block edges; "
          f"{busy_ms:.3f} ms of device time, {host_ms:.1f} ms host; launches {vis_launches}; "
          f"samples' sdf, std against decoder_forward_plain {err:.3e} (tol {TOL_MLP}); "
          f"updated-slot accumulators kept bitwise: {kept} ({name})", flush=True)
    if not err <= TOL_MLP:
        fail(f"visuals: samples differ from decoder_forward_plain by {err}")
    if not kept:
        fail("visuals: get_map_visuals changed the live mesher's updated-slot accumulators")
    if n_samples != len(pos) or n_samples == 0 or len(out["mesh"][0]) == 0:
        fail(f"visuals: {n_samples} samples of {len(pos)}, {len(out['mesh'][0])} triangles")
    if vis_launches["decoder_forward"] <= 0:
        fail("visuals: decoder_forward was not launched")

    # LM: the keyframe at frame VISUALS_FRAMES - 1, in the world frame
    pts, _, mask = pipe.tracker.last_processed_pc
    world = pts[mask] @ pipe.tracker.last_R.T + pipe.tracker.last_t
    world = world[::max(1, -(-len(world) // LM_POINTS))][:LM_POINTS]
    wrong = Isometry.from_twist(np.asarray(LM_XI))
    obs = ((world - torch.as_tensor(wrong.t, dtype=torch.float32, device=dev))
           @ torch.as_tensor(wrong.q.rotation_matrix, dtype=torch.float32, device=dev))
    if len(obs) < 1024:
        fail(f"lm: {len(obs)} points in the keyframe")
    ones = torch.ones(len(obs), dtype=torch.bool, device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def lm(decoder, n_iters=LM_ITERS):
        return track_points_lm(vmap.state, vmap.cfg, decoder, obs, ones, eye, zero,
                               n_iters=n_iters, bound_min=vmap.bound_min)

    lm(vmap.model.decoder, 2)                   # warm-up (cuSOLVER's handle)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        R, t, energy = lm(vmap.model.decoder)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    lm_launches = read_launches()
    ms_iter = start.elapsed_time(end) / LM_ITERS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:      # the kernels it runs
        lm(vmap.model.decoder)
        torch.cuda.synchronize()
    kernels_iter = sum(1 for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA
                       and not e.name().startswith(("Memcpy", "Memset"))) / LM_ITERS
    Rp, tp, energy_p = lm(PlainDecoder(vmap.model.decoder))
    err_true = _pose_err(R, t, wrong)
    err_plain = _pose_err(R, t, Isometry.from_matrix(Rp.double().cpu().numpy(),
                                                     tp.double().cpu().numpy(), ortho=True))
    print(f"lm: {len(obs)} points of the frame-{VISUALS_FRAMES - 1} keyframe, {LM_ITERS} "
          f"iterations under sync debug mode 'error': {ms_iter:.4f} ms an iteration (CUDA "
          f"events); pose error against the truth {1e3 * err_true[0]:.3f} mm, "
          f"{err_true[1]:.4f} deg; against the plain decoder's run {1e3 * err_plain[0]:.4f} "
          f"mm, {err_plain[1]:.5f} deg; energy {float(energy):.6f}, plain "
          f"{float(energy_p):.6f}; {kernels_iter:.1f} device kernels an iteration in a "
          f"trace; launches {lm_launches} ({name})", flush=True)
    if not (err_true[0] < 0.01 and err_true[1] < 1.0):
        fail(f"lm: pose error {err_true} against the truth (1 cm, 1 degree)")
    if not (err_plain[0] < 1e-3 and err_plain[1] < 0.05):
        fail(f"lm: pose error {err_plain} against the plain decoder's run (1 mm, 0.05 degree)")
    for k in ("decoder_forward", "decoder_forward_grad"):
        if lm_launches[k] != LM_ITERS:
            fail(f"lm: {lm_launches[k]} {k} launches, not one an iteration ({LM_ITERS})")
    print(f"visuals and lm phases: {time.perf_counter() - t0:.2f} s wall", flush=True)
    return vis_launches, lm_launches, dict(visuals_busy_ms=busy_ms, lm_ms_iter=ms_iter,
                                           lm_kernels_iter=kernels_iter)


def tp_phase():
    """The decoder's ``tp`` layout over two NCCL ranks (``tools/tp_check``),
    where the host has two cards; one card has nothing to shard."""
    import torch

    from nerf_fusion_tpu_torch.tools import tp_check

    n = torch.cuda.device_count()
    if n < 2:
        print(f"tp: skipped, {n} CUDA device (the tp layout needs two ranks on two cards)",
              flush=True)
        return
    t0 = time.perf_counter()
    res = tp_check.main(["--tp", "2", "--device", "cuda"])
    print(f"tp: 2 NCCL ranks within {res['err']:.3e} of one process "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


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
              "stencil_frontend", "photometric_hg", "gn_step", "sdf_rows", "sdf_hg")
    required = {
        "dense": fusion, "dense_det": fusion, "lrkt": fusion, "mesh_fast": fusion,
        "refine": fusion + ("decoder_vjp",), "async": fusion + ("decoder_vjp",),
        "hash_box": fusion + ("select_gather",),
        "fast": fusion + ("select_gather",), "lrkt_fast": fusion + ("select_gather",),
        "scannet_scale": fusion + ("select_gather",),
        "probe": ("row_gather", "row_gather_c1", "lane_gather"),
        "train": ("decoder_forward", "encoder_forward"),
        "scene": ("decoder_forward", "encoder_forward", "stencil_frontend"),
        "model_layer": ("decoder_forward",), "vis": fusion,
        "visuals": ("decoder_forward",), "lm": ("decoder_forward", "decoder_forward_grad"),
        "frontend_probe": ("stencil_count", "stencil_normals", "stencil_frontend"),
    }
    for label, names in required.items():
        for name in names:
            if paths[label][name] <= 0:
                fail(f"kernel {name} was not launched on the {label} path")
    # the warps gather inside the photometric kernel and the selection in
    # select_gather: the row gather runs on the probe only
    for label in ("dense", "fast", "dense_det", "fpc19", "vis", "refine", "mesh_fast",
                  "async", "hash_box", "lrkt", "lrkt_fast", "scannet_scale"):
        if any(paths[label]["row_gather_by_width"].values()):
            fail(f"row_gather ran on the {label} path: {paths[label]['row_gather_by_width']}")
    # on a fusion path the SDF term alone decodes with the gradient: each of
    # its evaluations launches sdf_rows, decoder_forward_grad and sdf_hg once
    for label in ("dense", "fast", "dense_det", "fpc19", "vis", "refine", "mesh_fast",
                  "async", "hash_box", "lrkt", "lrkt_fast", "scannet_scale"):
        p = paths[label]
        if not p["sdf_rows"] == p["sdf_hg"] == p["decoder_forward_grad"]:
            fail(f"{label}: sdf_rows {p['sdf_rows']}, sdf_hg {p['sdf_hg']}, "
                 f"decoder_forward_grad {p['decoder_forward_grad']} launches differ")
    for c in (1, 2, 4):
        if paths["probe"]["row_gather_by_width"][c] <= 0:
            fail(f"row_gather at width {c} was not launched on the probe path")
    for name in KERNEL_ROWS:
        if sum(p.get(name, 0) for p in paths.values()) <= 0:
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
    gather_ptxas(report)
    tensor_cores = tensor_core_counts()
    rows = kernel_phase(dev)
    vjp_summary(rows, report)
    render_check(dev)
    paths = {}
    paths["dense"], dense_res = fusion_path(dev, "dense")
    paths["fast"], _ = fusion_path(dev, "fast", FAST_EXEC)
    # 19 tracking-only frames fill the 20-frame cadence; held against the
    # dense path run again, both under deterministic algorithms: otherwise
    # the map's and the box filter's index_add_ atomics differ between runs
    # in the last bits, which GN tracking turns into tenths of a millimetre
    # of ATE (0.33 mm between the dense and fpc19 runs of one call)
    shutil.rmtree(REPO / "output" / "chip_smoke" / "vis" / "preview", ignore_errors=True)
    with deterministic():
        paths["dense_det"], dense = fusion_path(dev, "dense_det", after=keep_poses)
        paths["fpc19"], block = fusion_path(dev, "fpc19", "frames_per_call=19")
        t0 = time.perf_counter()
        paths["vis"], vis = fusion_path(dev, "vis", argv=VIS_ARGV, after=keep_poses)
        vis_wall = time.perf_counter() - t0
    for key in ("ate_rmse", "mesh_abs_sdf"):
        if not abs(block[key] - dense[key]) <= 3e-4:
            fail(f"frames_per_call = 19: {key} {block[key]} m against the per-frame "
                 f"run's {dense[key]} m")
    vis_check(vis, dense, vis_wall)
    paths["visuals"], paths["lm"], _ = visuals_lm_phase(dev)
    tp_phase()
    option_paths(dev, paths, dense_res)
    paths["probe"], _ = probe_path("gather", gather_probe)
    paths["frontend_probe"], _ = probe_path("frontend", preprocess_probe)
    # the three configs of the data layer, each as its file gives it; the
    # lr-kt configs read the exported room (uint8 / uint16 frames, uploaded
    # ahead on a side stream), scannet-scale renders the large scene
    lrkt_exec = lrkt_export(dev)
    paths["lrkt"], _ = fusion_path(dev, "lrkt", lrkt_exec, LRKT_CONFIG)
    paths["lrkt_fast"], _ = fusion_path(dev, "lrkt_fast", lrkt_exec, LRKT_FAST_CONFIG)
    paths["scannet_scale"], _ = fusion_path(dev, "scannet_scale", None, SCANNET_CONFIG,
                                            SCANNET_FRAMES)
    prefetch_check(dev, lrkt_exec)
    paths["train"], train = train_path(dev)
    paths["scene"], _ = scene_path(dev)
    paths["dp"], _ = dp_path(dev, train["lif_dir"])
    paths["model_layer"], _ = model_layer_phase(dev)
    check_launches(paths)
    kernels = []
    for r in rows:
        by_path = {label: p.get(r["name"], 0) for label, p in paths.items()}
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["err"], "tolerance": r["tol"],
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "bound_peak": r.get("bound_peak") or (
                "tf32 tensor cores, 3 passes" if r["name"] in tensor_cores
                else "f32 CUDA cores" if r["bound"][1] == "operations" else "HBM"),
            **({"bound_f32_ms": r["bound_f32"][0]} if "bound_f32" in r else {}),
            **({"tensor_core_instructions": tensor_cores[r["name"]]}
               if r["name"] in tensor_cores else {}),
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **{k: r[k] for k in ("grad_err", "grad_tol", "grad_within_tol", "row_rel_err",
                                 "row_tol", "row_within_tol", "count_err",
                                 "normal_agree_frac", "mask_diff", "pts_equal",
                                 "off_mask_zero", "repeat_equal", "ms_again",
                                 "selection_matches_cpu", "recorded_steps", "cases",
                                 "rows_used",
                                 "edge_cases", "registers", "spill_stores", "spill_loads")
               if k in r}})
    if sorted(k["name"] for k in kernels) != sorted(KERNEL_ROWS):
        fail(f"kernel rows {[k['name'] for k in kernels]} are not {KERNEL_ROWS}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
