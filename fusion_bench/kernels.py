"""The program's kernels as a device trace names them, and the work of the
traced cadence cycles by kernel.

Calls and sizes are the work the inputs need: the configuration's and the
traffic camera's sizes, the tracker's evaluations of each GN group, the
launch counters, and what each traced frame held: its valid points (the
processed cloud's mask), the voxels each mesh extraction decoded (its
``keep`` mask), and the corner pairs that count in each latent refinement
(its targets' weights).  Never a buffer's capacity or a kernel's chunking.  A
kernel whose calls cannot all be given a size leaves its metrics out.
"""

from __future__ import annotations

import re

from . import discovery
from .rooflines import PEAK_TF32, model_flops

NAMES = (("decoder_kernel<false>", "decoder_forward"),
         ("decoder_kernel<true>", "decoder_forward_grad"),
         ("decoder_vjp_kernel", "decoder_vjp"),
         ("encoder_kernel", "encoder_forward"),
         ("photometric_kernel", "photometric_hg"),
         ("gn_step_kernel", "gn_step"),
         ("select_gather_kernel", "select_gather"),
         ("sdf_rows_kernel", "sdf_rows"),
         ("sdf_hg_kernel", "sdf_hg"))


def kernel_of(name: str):
    """The kernel a device event runs, by the program's kernel names."""
    for key, kernel in NAMES:
        if key in name:
            return kernel
    if re.search(r"stencil_kernel<\(\(anonymous namespace\)::Mode\)2>", name):
        return "stencil_frontend"
    return None


def _levels(fusion: dict, cam: dict):
    """Pixels the photometric term evaluates at each pyramid level."""
    rgb = fusion["tracking"]["rgb"]
    stride, budget = int(rgb.get("stride", 1)), int(rgb.get("pixel_budget", 0))
    W, H = int(cam["width"]), int(cam["height"])
    out = {}
    for lev in range(3):
        h, w = H >> lev, W >> lev
        grid = ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
        out[lev] = min(budget, grid) if budget > 0 else grid
    return out, budget > 0


def mlp_rows(ctx: dict, index: int):
    """{kernel: [(rows, calls, units)]} of the MLP kernels in the ``index``-th
    traced frame, and the set of those that ran with a size not known.
    ``units``: how many times ``rows`` are computed: once a call, or once for
    all the decoder calls of one extraction, which share its rows.  A
    refinement's ``n_iters`` Adam steps are a ``decoder_forward`` and a
    ``decoder_vjp`` call each, of the corner pairs that count."""
    tr = ctx["trace"]
    f, counts = tr["frames"][index], tr["launches"][index]
    side = 2 * int(ctx["config"]["fusion"]["resolution"])
    out, unknown = {}, set()
    n = counts.get("decoder_forward_grad", 0)
    if n:
        # each call reads the first ``gn_points`` rows of the frame's cloud
        out["decoder_forward_grad"] = [(tr["gn_rows"][index], n, n)]
    n = counts.get("encoder_forward", 0)
    if n == 1:
        # the integration encodes each valid point at its voxel's 8 corners
        out["encoder_forward"] = [(8 * tr["valid_points"][index], 1, 1)]
    elif n:
        unknown.add("encoder_forward")
    ext = [(voxels, calls) for g, voxels, calls in tr["extractions"] if g == f]
    ref = [(pairs, iters, iters) for g, pairs, iters in tr.get("refines", ()) if g == f]
    # the calls launched and the calls due: the frame's own, or where the jobs
    # run on the worker beside later frames (``async``), the traced frames'
    # together, each job's rows counted in the frame that dispatched it
    if tr.get("async"):
        launched = lambda k, _=0: sum(c.get(k, 0) for c in tr["launches"])
        steps = sum(i for _, _, i in tr.get("refines", ()))
        extracted = sum(c for _, _, c in tr["extractions"])
    else:
        launched = counts.get
        steps = sum(c for _, c, _ in ref)
        extracted = sum(c for _, c in ext)
    n = launched("decoder_forward", 0)
    if n and extracted + steps == n:
        # every sample of every voxel an extraction keeps, its calls together
        out["decoder_forward"] = [(voxels * side ** 3, calls, 1)
                                  for voxels, calls in ext] + ref
    elif n:
        unknown.add("decoder_forward")
    n = launched("decoder_vjp", 0)
    if n and steps == n:
        out["decoder_vjp"] = ref
    elif n:
        unknown.add("decoder_vjp")
    return out, unknown


def traced_work(ctx: dict):
    """({kernel: [(sizes, calls, units)]} over the traced frames, the kernels
    whose calls are not all sized).  ``units``: how many times the least time
    of ``sizes`` is due (``mlp_rows``)."""
    tr = ctx["trace"]
    fusion, cam = ctx["config"]["fusion"], ctx["traffic"]["camera"]
    pix, sparse = _levels(fusion, cam)
    groups = fusion["tracking"]["iter_config"]
    launches = tr["launches"]
    tot = lambda k: sum(f.get(k, 0) for f in launches)
    work = {"gn_step": [({}, tot("gn_step"), tot("gn_step"))]}
    unknown = set()
    for i in range(len(tr["frames"])):
        rows, bad = mlp_rows(ctx, i)
        unknown |= bad
        for k, entries in rows.items():
            work.setdefault(k, []).extend(({"rows": r}, n, u) for r, n, u in entries)
        # the SDF term's kernels around each decoder_forward_grad call, on its rows
        for k in ("sdf_rows", "sdf_hg"):
            n = launches[i].get(k, 0)
            if n:
                work.setdefault(k, []).append(({"rows": tr["gn_rows"][i]}, n, n))
    photo = {}
    for counts in tr["groups"]:
        for g, n in enumerate(counts):
            for term in groups[g]["type"]:
                if term[0] == "rgb":
                    lev = int(term[1]) if len(term) > 1 else 0
                    photo[lev] = photo.get(lev, 0) + n
    work["photometric_hg"] = [({"pixels": pix[lev], "sparse": sparse}, n, n)
                              for lev, n in sorted(photo.items())]
    sub = float(fusion["tracking"]["sdf"].get("subsample", 0.5))
    px = int(cam["height"] * sub) * int(cam["width"] * sub)
    work["stencil_frontend"] = [({"pixels": px}, tot("stencil_frontend"),
                                 tot("stencil_frontend"))]
    if sparse:
        levels = sorted({int(t[1]) if len(t) > 1 else 0 for g in groups for t in g["type"]
                         if t[0] == "rgb"})
        per_frame = tot("select_gather") / max(len(levels) * len(launches), 1)
        work["select_gather"] = [({"selected": pix[lev]}, per_frame * len(launches),
                                  per_frame * len(launches)) for lev in levels]
    return work, unknown


def roofline_share(ctx: dict, kernels) -> float:
    """Sum of the kernels' least times over the sum of their trace times, in
    percent; a kernel's trace time is its mean traced call times its calls
    (a trace may lose events).  None where nothing of them ran, or where one
    of them ran with a size not known."""
    tr = ctx.get("trace")
    if not tr or "trace" not in tr:
        return None
    work, unknown = traced_work(ctx)
    if unknown & set(kernels):
        return None
    durations = {}
    for name, s, e in tr["trace"].device:
        k = kernel_of(name)
        if k is not None:
            durations.setdefault(k, []).append((e - s) * 1e-6)
    least = spent = 0.0
    for k in kernels:
        calls = sum(n for _, n, _ in work.get(k, []))
        if calls == 0 or not durations.get(k):
            continue
        least += sum(u * discovery.bound_s(k, **sizes) for sizes, _, u in work[k])
        spent += sum(durations[k]) / len(durations[k]) * calls
    return 100.0 * least / spent if spent > 0 else None


def mlp_flops(ctx: dict, indices) -> float:
    """The prior's model FLOPs of the MLP rows of the traced frames
    ``indices``; None where a call's rows are not known."""
    flops = 0.0
    for i in indices:
        rows, unknown = mlp_rows(ctx, i)
        if unknown:
            return None
        flops += sum(model_flops(k, r) * u for k, entries in rows.items()
                     for r, _, u in entries)
    return flops


def peak_share(flops: float, seconds: float) -> float:
    return 100.0 * flops / (seconds * PEAK_TF32)
