"""One run of one cell: set-up, the measured window, the trace, the check.

The cell names a configuration (``configs/<name>.json``: the fusion
settings as the program reads them, the prior, the reference's sizes) and a
traffic mix (``traffic/<name>.json``: scene, trajectory and cycle, camera,
depth noise and its seed, tracked or posed).  Set-up loads the program and
the prior, renders the traffic's frames on the device
(``reference.render``), builds ``FusionPipeline`` and runs the traffic's
warm-up cycles.  The run's seed picks the loop's starting frame and the
frames the check samples.  The window is a closed loop: each frame goes to
``FusionPipeline.process_frame`` as soon as the previous call returned,
the frame counter running on, so ``frame_id % integrate_interval`` keeps the
cadence; a CUDA event is recorded after each call.  The garbage collector
makes no collection inside the window.  With ``trace`` the profiler
records ``trace_cycles`` whole cadence cycles inside the window, with the
sizes their kernels' work is counted from (``kernels.py``).

After the window the loop runs on, untimed, to the second cadence frame
after it; the map's state and the processed cloud of both cadence frames,
the second's mesh batch and the GN evaluations of the frames between are
kept, and ``check.py`` holds them against the plain reference once the
program is freed.

Where the configuration refines latents (``do_optimize``), ``RefineTap``
keeps, in set-up, the refinement of most eligible voxels with its frame's
cloud and pose; over the traced frames, the corner pairs each refinement's
steps count; over the check's interval, each refinement's jitter and
result.  The window's refinements are read after it from the map's own
log (their CUDA events, eligible and sampled voxels).
"""

from __future__ import annotations

import gc
import json
import random
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import discovery
from .reference import render

BANNED = ("jax", "jaxlib", "flax", "nerf_fusion_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is banned (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Traffic:
    """The frames of a traffic mix on the device and their order."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        cam = spec["camera"]
        W, H = int(cam["width"]), int(cam["height"])
        s = W / float(cam["base_width"])
        self.calib = {"fx": cam["f"] * s, "fy": cam["f"] * s,
                      "cx": W / 2.0 - 0.5, "cy": H / 2.0 - 0.5}
        self.poses = render.trajectory(spec["trajectory"])
        self.order = render.cycle_order(len(self.poses), spec["cycle"])
        rng = random.Random(seed)
        self.start = rng.randrange(len(self.order))
        self.rng = rng
        # the noise is the traffic's, the same for every seed: the seed picks
        # the order (the loop's starting frame), so every run does the same work
        gen = torch.Generator(device=device).manual_seed(int(spec["noise"]["seed"]))
        R = torch.as_tensor(self.poses[:, :3, :3], dtype=torch.float32, device=device)
        t = torch.as_tensor(self.poses[:, :3, 3], dtype=torch.float32, device=device)
        c, noise = self.calib, spec["noise"]
        rgb, depth = [], []
        B = int(spec.get("render_batch", 16))
        for lo in range(0, len(self.poses), B):
            r, d = render.render(R[lo:lo + B], t[lo:lo + B], c["fx"], c["fy"], c["cx"],
                                 c["cy"], H, W, spec["scene"])
            rgb.append(r)
            for k in range(d.shape[0]):
                depth.append(render.kinect_noise(d[k], gen, noise["sigma0"], noise["k"],
                                                 noise["z0"]))
        self.rgb = torch.cat(rgb)
        self.depth = torch.stack(depth)
        self.posed = bool(spec.get("posed", False))
        self.intrinsic = SimpleNamespace(dscale=5000.0, **self.calib)

    def index(self, frame_id: int) -> int:
        """The trajectory frame played at ``frame_id``."""
        return self.order[(self.start + frame_id) % len(self.order)]

    def pose(self, frame_id: int) -> np.ndarray:
        return self.poses[self.index(frame_id)]

    def frame(self, frame_id: int):
        i = self.index(frame_id)
        T = self.poses[i]
        gt = SimpleNamespace(q=SimpleNamespace(rotation_matrix=T[:3, :3]), t=T[:3, 3])
        return SimpleNamespace(rgb=self.rgb[i], depth=self.depth[i], gt_pose=gt,
                               calib=self.intrinsic)


def program_args(fusion: dict, model_args):
    from nerf_fusion_tpu_torch.utils.config import dict_to_args

    args = dict_to_args(json.loads(json.dumps(fusion)))
    args.model = model_args
    args.mapping = dict_to_args(dict(fusion["mapping"]))
    args.tracking = dict_to_args(dict(fusion["tracking"]))
    args.first_iso = None
    return args


class ExtractTap:
    """Each result of the mesher's ``fused_extract`` while installed, with
    the frame it ran in (``frame_id``, set by the caller), and the
    ``decoder_forward`` launches inside it."""

    def __init__(self, keep_all: bool):
        import nerf_fusion_tpu_torch.system.mesher as mesher_mod
        from nerf_fusion_tpu_torch.ops import launches

        self.mod = mesher_mod
        self.orig = mesher_mod.fused_extract
        self.frame_id = None
        self.calls = []

        def fused_extract(*a, **k):
            before = launches.snapshot()
            out = self.orig(*a, **k)
            n = launches.diff(launches.snapshot(), before)["decoder_forward"]
            # (result, mesh ids, keep, ...): a traced frame keeps the mask alone,
            # so that no mesh buffer outlives its frame
            self.calls.append((self.frame_id, out if keep_all else (None, None, out[2]), n))
            return out

        mesher_mod.fused_extract = fused_extract

    def close(self):
        self.mod.fused_extract = self.orig


class RefineTap:
    """Each latent refinement of the map while installed, with the frame it
    ran in (``frame_id``, set by the caller): wraps ``system.refine.
    refine_latents_core``, which the map reaches through ``refine_latents``
    and the module, and ``refine_targets``, which the core calls.  ``keep``:

    * ``"rows"`` (traced frames): (frame id, the pairs that count as a
      device tensor, ``n_iters``) in ``calls``; no host read;
    * ``"check"``: a dict a call in ``calls``: the jitter, ``n_iters``,
      ``code_reg_lambda``, the refined slots and latents, the mean NLL a
      step (the map's log);
    * ``"best"`` (set-up): the same for the call with the most eligible
      voxels only, in ``best``, with a copy of the state passed in; the
      count is read on the host after each call."""

    def __init__(self, keep: str):
        import nerf_fusion_tpu_torch.system.refine as refine_mod

        self.mod, self.keep = refine_mod, keep
        self.orig, self.orig_targets = refine_mod.refine_latents_core, refine_mod.refine_targets
        self.frame_id, self.calls, self.best = None, [], None
        made = []

        def refine_targets(*a, **k):
            made.append(self.orig_targets(*a, **k))
            return made[-1]

        # the map passes n_iters, code_reg_lambda and its log by keyword
        def core(state, cfg, decoder, points, normals, valid, gt_sdf, **k):
            made.clear()
            res = self.orig(state, cfg, decoder, points, normals, valid, gt_sdf, **k)
            if self.keep == "rows":
                pairs = made[-1].weight.sum() if made else None
                self.calls.append((self.frame_id, pairs, int(k["n_iters"])))
                return res
            rec = {"frame_id": self.frame_id, "gt": gt_sdf, "n_iters": int(k["n_iters"]),
                   "code_reg_lambda": float(k["code_reg_lambda"]), "refined": res.refined,
                   "latents": res.latents, "nll": (k.get("log") or {}).get("nll")}
            if self.keep == "check":
                self.calls.append(rec)
            else:
                rec["eligible"] = int(res.refined.sum())
                if self.best is None or rec["eligible"] > self.best["eligible"]:
                    rec["state"] = {f: getattr(state, f).clone() for f in state._fields}
                    self.best = rec
            return res

        refine_mod.refine_targets = refine_targets
        refine_mod.refine_latents_core = core

    def close(self):
        self.mod.refine_latents_core = self.orig
        self.mod.refine_targets = self.orig_targets


class Capture:
    """What the check reads: after each cadence frame a copy of the map
    state and of the frame's processed cloud, and the mesher's batch of the
    frame's extraction (``fused_extract``'s result); with ``refine``, each
    refinement (``RefineTap``)."""

    def __init__(self, refine: bool = False):
        self.tap = ExtractTap(keep_all=True)
        self.refine = RefineTap("check") if refine else None
        self.cadences = []

    def close(self):
        self.tap.close()
        if self.refine is not None:
            self.refine.close()

    def after_cadence(self, pipe, frame_id: int):
        st = pipe.map.state
        pts, nrm, mask = pipe.tracker.last_processed_pc
        batch = next((out for f, out, _ in reversed(self.tap.calls) if f == frame_id), None)
        self.cadences.append({
            "frame_id": frame_id,
            "state": {k: getattr(st, k).clone() for k in st._fields},
            "cloud": (pts.clone(), nrm.clone(), mask.clone()),
            "batch": None if batch is None else (batch[1], batch[2], batch[0])})


class GroupCounter:
    """Evaluations of each GN group of each tracked frame, by frame id
    (``by_frame``; the caller sets ``frame_id``): wraps the tracker's host
    loop, ``run_groups``.  Installed over the traced frames and the check's
    interval only."""

    def __init__(self):
        import nerf_fusion_tpu_torch.system.tracker as tracker_mod

        self.mod = tracker_mod
        self.orig = tracker_mod.run_groups
        self.by_frame = {}
        self.frame_id = None

        def run_groups(tcfg, state, iteration):
            counts = [0] * len(tcfg.iter_config)

            def counted(group):
                counts[group] += 1
                return iteration(group)

            out = self.orig(tcfg, state, counted)
            self.by_frame[self.frame_id] = counts
            return out

        tracker_mod.run_groups = run_groups

    def close(self):
        self.mod.run_groups = self.orig


def power_limit() -> str:
    try:
        import subprocess

        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict = None, control: bool = False, t_start: float = None,
             log=None) -> dict:
    """One run: {"ctx": what the metric readers read, "checks": {number:
    [value, limit]}, "failed", "readings" (each side's numbers), "banned"
    (JAX modules loaded), "memory_peak", "kind", "count"}.  ``control``:
    the checks judge the control (``check.run``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    overrides = overrides or {}
    bench = discovery.benchmark()
    cell = discovery.cell(bench, workload)
    config = merge(discovery.config(bench, cell["config"]), overrides.get("config"))
    traffic_spec = merge(discovery.traffic(cell["traffic"]), overrides.get("traffic"))
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nerf_fusion_tpu_torch.models.io import load_model
    from nerf_fusion_tpu_torch.ops import launches
    from nerf_fusion_tpu_torch.system.pipeline import FusionPipeline

    fusion = config["fusion"]
    prior_dir = discovery.ROOT / config["prior"]["dir"]
    model, model_args = load_model(prior_dir / "hyper.json", int(config["prior"]["epoch"]))
    traffic = Traffic(traffic_spec, seed, dev)
    pipe = FusionPipeline(model, program_args(fusion, model_args), dev)
    cadence = int(fusion["integrate_interval"])
    gn_rows = int(config["reference"]["gn_points"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def step(fid):
        pipe.process_frame(traffic.frame(fid), fid, use_gt_pose=traffic.posed)

    # set-up: the warm-up cycles; with refinement the one of most eligible
    # voxels is kept for the check, with its frame's cloud and pose
    refining = bool(fusion.get("do_optimize", False))
    setup_tap = RefineTap("best") if refining else None
    n_warm = int(traffic_spec["warm_cycles"]) * len(traffic.order)
    for fid in range(n_warm):
        if setup_tap is not None:
            setup_tap.frame_id = fid
        step(fid)
        best = setup_tap.best if setup_tap is not None else None
        if best is not None and best["frame_id"] == fid and "cloud" not in best:
            best["cloud"] = tuple(x.clone() for x in pipe.tracker.last_processed_pc)
            best["pose"] = pipe.tracker.all_pd_pose[fid]
    if setup_tap is not None:
        setup_tap.close()
    fid = n_warm
    pipe.mesher.current_mesh()
    sync()

    # -- the window ---------------------------------------------------------
    n_trace = int(traffic_spec["trace_cycles"]) * cadence
    cuda = dev.type == "cuda"
    events, frame_ids, traced = [], [], []
    prof = trace_info = counter = tap = rtap = None
    launches0, reads0 = launches.snapshot(), pipe.tracker.host_reads
    refines0 = len(pipe.map.refine_log)
    start_ev = torch.cuda.Event(enable_timing=True) if cuda else None
    # no collection of the garbage collector inside the window: what set-up
    # made is frozen, and what the window makes waits for its close
    gc.collect()
    gc.freeze()
    gc.disable()
    sync()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    if cuda:
        start_ev.record()
    trace_from = None
    while True:
        if trace and prof is None and trace_from is None and fid % cadence == 1 \
                and time.perf_counter() - t0 >= 0.3 * seconds:
            trace_from = fid
            sync()
            from torch.profiler import ProfilerActivity, profile

            counter, tap = GroupCounter(), ExtractTap(keep_all=False)
            rtap = RefineTap("rows") if refining else None
            # the device's activity and the host's CUDA calls only: recording every
            # host operator would slow the host, which paces these frames
            acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
            prof = profile(activities=acts)
            prof.__enter__()
            per_frame, sizes, snap = [], [], launches.snapshot()
        tracing = prof is not None and trace_info is None
        if tracing:
            counter.frame_id = tap.frame_id = fid
            if rtap is not None:
                rtap.frame_id = fid
        step(fid)
        if tracing:
            now = launches.snapshot()
            per_frame.append(launches.diff(now, snap))
            snap = now
            # the frame's valid points, and those of the rows the SDF term reads
            mask = pipe.tracker.last_processed_pc[2]
            sizes.append((mask.sum(), mask[:gn_rows].sum()))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            events.append(time.perf_counter())
        frame_ids.append(fid)
        traced.append(tracing)
        if tracing and fid == trace_from + n_trace - 1:
            sync()
            prof.__exit__(None, None, None)
            counter.close()
            tap.close()
            if rtap is not None:
                rtap.close()
            frames = list(range(trace_from, trace_from + n_trace))
            trace_info = {
                "frames": frames, "launches": per_frame,
                "groups": [counter.by_frame[f] for f in frames if f in counter.by_frame],
                "sizes": sizes, "extractions": tap.calls,
                "refines": rtap.calls if rtap is not None else []}
        fid += 1
        if time.perf_counter() - t0 >= seconds and (prof is None or trace_info is not None):
            break
    sync()
    window_s = time.perf_counter() - t0
    gc.enable()
    gc.unfreeze()
    launches1, reads1 = launches.snapshot(), pipe.tracker.host_reads
    refines1 = len(pipe.map.refine_log)
    if cuda:
        ms = [start_ev.elapsed_time(events[0])] + [
            a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        stamps = [t0] + events
        ms = [1e3 * (b - a) for a, b in zip(stamps[:-1], stamps[1:])]
        memory_peak, kind = 0, "cpu"
    log(f"window: {len(frame_ids)} frames; the garbage collector then found "
        f"{gc.collect()} unreachable objects")
    if trace and trace_info is not None:
        sizes = trace_info.pop("sizes")
        trace_info["valid_points"] = [int(a) for a, _ in sizes]
        trace_info["gn_rows"] = [int(b) for _, b in sizes]
        trace_info["extractions"] = [(f, int(out[2].sum()), n)
                                     for f, out, n in trace_info["extractions"]]
        # a refinement's rows: the corner pairs that count, in each of its steps
        trace_info["refines"] = [(f, int(pairs), iters)
                                 for f, pairs, iters in trace_info["refines"]]
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            from .tracefile import Trace

            trace_info["trace"] = Trace.load(path)
        del prof
    occupied = int(pipe.map.state.n_occupied)
    # the window's refinements, from the program's own log (its events read now)
    window_refines = pipe.map.refine_summary()[refines0:refines1]
    refine_info = {"n_iters": int(pipe.map.optim_n_iters), "count": refines1 - refines0,
                   **{k: [e[k] for e in window_refines] for k in ("ms", "eligible", "sampled")}}
    if window_refines:
        log("refine: the window's {count} refinements: ms, eligible, sampled voxels "
            "(min / median / max) {r}".format(count=refine_info["count"], r=[
                (min(v), float(np.median(v)), max(v))
                for v in (refine_info[k] for k in ("ms", "eligible", "sampled"))]))

    # -- the check's interval ------------------------------------------------
    # The same loop runs on, untimed, to the second cadence frame after the
    # window: the map and the cloud of both cadences, the mesh batch of the
    # second and the GN evaluations of each frame between them are kept.
    # Nothing of the check runs inside the window.
    capture, groups = Capture(refine=refining), GroupCounter()
    while len(capture.cadences) < 2:
        groups.frame_id = capture.tap.frame_id = fid
        if refining:
            capture.refine.frame_id = fid
        step(fid)
        if fid % cadence == 0:
            capture.after_cadence(pipe, fid)
        fid += 1
    capture.close()
    groups.close()
    sync()

    # -- what the check reads, then the program is freed --------------------
    # each frame's pose is a tensor of its own, which no later frame rewrites
    poses = list(pipe.tracker.all_pd_pose)
    found = banned_modules()
    ctx = {
        "config": config, "traffic": traffic_spec, "frame_ids": frame_ids, "interval_ms": ms,
        "traced": traced, "cadence": cadence, "window_s": window_s, "setup_s": setup_s,
        "trace": trace_info, "launches": launches.diff(launches1, launches0),
        "host_reads": reads1 - reads0, "occupied_voxels": occupied, "refine": refine_info,
        "power_limit": power_limit() if cuda else "cpu",
    }
    cadences = capture.cadences
    refines = {"check": capture.refine.calls if refining else [],
               "setup": setup_tap.best if refining else None}
    del pipe, model, capture, setup_tap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from . import check

    checks, failed, readings = check.run(
        config, traffic, cadences, poses, frame_ids, dev, log=log, control=control,
        program_evals=groups.by_frame, refines=refines)
    return {"ctx": ctx, "checks": checks, "failed": failed, "readings": readings,
            "banned": found,
            "memory_peak": memory_peak, "kind": kind, "count": 1 if cuda else 0}
