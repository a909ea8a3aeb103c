#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels (``nerf_fusion_tpu_torch/csrc/*.cu``, one
   ``nvcc`` per source, in parallel) and prints the build time.
2. Holds every kernel against its plain PyTorch version on the card at
   the fusion loop's shapes and times both.
3. Runs the fusion loop through its entry point
   (``nerf_fusion_tpu_torch.main configs/fusion-synth.yaml``, 640x480, all
   100 frames) with the launch counters zeroed just before, and fails
   unless every kernel launched, the box filter dropped nothing, and ATE
   and mesh |SDF| are below 20 mm.
4. Prints the ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, if any phase fails or no GPU is
available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = "configs/fusion-synth.yaml"
# NVIDIA H100 SXM data sheet peaks (dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL_MLP = 1e-4          # decoder / encoder outputs: f32, summation order only
TOL_GRAD = 1e-3         # decoder input gradient
TOL_NORMAL_DOT = 0.999  # |n . n_plain| on 99 % of the valid pixels


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from nerf_fusion_tpu_torch.data.synth import SyntheticSequence
    from nerf_fusion_tpu_torch.models.io import load_model
    from nerf_fusion_tpu_torch.ops import imgproc, mlp, stencil
    from nerf_fusion_tpu_torch.system.mesher import _sample_offsets

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
        name="decoder_forward", fn=mlp.decoder_forward, err=err, tol=TOL_MLP,
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="nerf_fusion_tpu/ops/pallas_mlp.py:98 (_decoder_pallas_call)",
        shape=f"({n}, 32) -> ({n}, 2)",
        ms=time_ms(lambda: mlp.decoder_forward(x, dec.packed, dec.mats)),
        plain_ms=time_ms(lambda: mlp.decoder_forward_plain(x, dec.mats)),
        bound=bound_ms(2 * 49408 * n, n * (32 + 2) * 4 + 49890 * 4)))

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
        name="decoder_forward_grad", fn=mlp.decoder_forward_grad, err=err, tol=TOL_MLP,
        grad_err=float(gdiff.max()), grad_tol=TOL_GRAD,
        grad_within_tol=float((gdiff <= TOL_GRAD).float().mean()),
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="nerf_fusion_tpu/ops/pallas_mlp.py:98 (_decoder_pallas_call)",
        shape=f"({n}, 32) -> ({n}, 2) + ({n}, 3)",
        ms=time_ms(lambda: mlp.decoder_forward_grad(xg, dec.packed, dec.mats)),
        plain_ms=time_ms(lambda: mlp.decoder_forward_grad_plain(xg, dec.mats)),
        bound=bound_ms(2 * (49408 + 3 * (128 * 128 + 128 * 96 + 96 * 128 + 128)) * n,
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
        name="encoder_forward", fn=mlp.encoder_forward,
        err=float((out - ref).abs().max()), tol=TOL_MLP,
        source="nerf_fusion_tpu_torch/csrc/mlp.cu",
        replaces="nerf_fusion_tpu/ops/pallas_mlp.py:165 (_encoder_pallas_call)",
        shape=f"({n}, 6) -> ({n}, 29)",
        ms=time_ms(lambda: mlp.encoder_forward(xe, enc.packed, enc.mats)),
        plain_ms=time_ms(lambda: mlp.encoder_forward_plain(xe, enc.mats)),
        bound=bound_ms(2 * 26048 * n, n * (6 + 29) * 4 + 26429 * 4)))

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
        name="stencil_count", fn=stencil.neighbor_count,
        err=float((cnt - cref).abs().max()), tol=0.0,
        source="nerf_fusion_tpu_torch/csrc/stencil.cu",
        replaces="nerf_fusion_tpu/ops/pallas_stencil.py:202 (_padded_call via "
                 "neighbor_count_pallas :238)",
        shape=f"(3, {H}, {W}) + ({H}, {W}) -> ({H}, {W})",
        ms=time_ms(lambda: stencil.neighbor_count(pts0, valid, 0.05), 100),
        plain_ms=time_ms(lambda: stencil.neighbor_count_plain(pts0, valid, 0.05)),
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
        name="stencil_normals", fn=stencil.normals_stencil,
        err=float((nrm_k - nrm_p)[:, m].abs().max()), tol=None,
        normal_agree_frac=frac, count_err=float((cnt_k - cnt_p).abs().max()),
        source="nerf_fusion_tpu_torch/csrc/stencil.cu",
        replaces="nerf_fusion_tpu/ops/pallas_stencil.py:202 (_padded_call via "
                 "normals_stencil_pallas :218)",
        shape=f"(3, {H}, {W}) + ({H}, {W}) -> (3, {H}, {W}) + ({H}, {W})",
        ms=time_ms(lambda: stencil.normals_stencil(pts0, gated, 0.1), 100),
        plain_ms=time_ms(lambda: stencil.normals_stencil_plain(pts0, gated, 0.1)),
        bound=bound_ms(n_valid * (49 * 8 + 100) + n_acc * 16, px * (13 + 16))))

    for r in rows:
        extra = {k: r[k] for k in ("grad_err", "grad_within_tol", "normal_agree_frac",
                                   "count_err")
                 if k in r}
        print(f"kernel {r['name']}: {r['shape']} max_abs_err {r['err']:.3e} {extra} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)
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
    g = rows[1]
    if g["grad_within_tol"] < 0.999:
        fail(f"decoder_forward_grad: gradient within {TOL_GRAD} on only "
             f"{g['grad_within_tol']:.5f} of the points")
    return rows


def main_path(dev):
    """The fusion loop through its entry point, launch counters zeroed."""
    import torch

    from nerf_fusion_tpu_torch import main as entry
    from nerf_fusion_tpu_torch.ops import mlp, stencil

    wrappers = (mlp.decoder_forward, mlp.decoder_forward_grad, mlp.encoder_forward,
                stencil.neighbor_count, stencil.normals_stencil)
    for w in wrappers:
        w.launches = 0
    out_dir = REPO / "output" / "chip_smoke"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = entry.main([str(REPO / CONFIG), "--device", str(dev),
                      "--output", str(out_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    n = res["n_frames"]
    stages = {k: round(v["mean_ms"], 3) for k, v in res["timing"].items()}
    print(f"main path: {n} frames in {wall:.2f} s ({n / wall:.2f} fps incl. "
          f"rendering and output), stage mean ms {stages}", flush=True)
    print(f"main path: ATE {1e3 * res['ate_rmse']:.3f} mm, mesh |SDF| "
          f"{1e3 * res.get('mesh_abs_sdf', float('nan')):.3f} mm, "
          f"{res['n_triangles']} triangles, box-filter drop_frac "
          f"{res['box_filter_drop_frac']}, launches {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if res["box_filter_drop_frac"]["max"] != 0.0:
        fail(f"box filter dropped points: {res['box_filter_drop_frac']}")
    if not res["ate_rmse"] < 0.02:
        fail(f"ATE {res['ate_rmse']} m >= 0.02")
    if not res.get("mesh_abs_sdf", 1.0) < 0.02:
        fail(f"mesh |SDF| {res.get('mesh_abs_sdf')} m >= 0.02")
    if res["n_triangles"] <= 0:
        fail("empty mesh")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from nerf_fusion_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)}", flush=True)
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")
    rows = kernel_phase(dev)
    launches = main_path(dev)
    kernels = []
    for r in rows:
        fn_name = r["fn"].__name__
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[fn_name],
            "max_abs_err": r["err"], "tolerance": r["tol"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "shape": r["shape"],
            **{k: r[k] for k in ("grad_err", "grad_tol", "grad_within_tol", "count_err",
                                 "normal_agree_frac") if k in r}})
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
