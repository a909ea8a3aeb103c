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

With ``run_async`` the refinement and the cadence mesh run as jobs on the
map's worker (a thread and a CUDA stream) beside later frames.  ``Frames``
keys each job to the frame that dispatched it, for every tap; the harness
waits for the jobs (never collecting one: the program merges and returns
each where it would) at the window's two ends, at the trace's two ends,
so that the traced frames hold every kernel of the jobs they dispatch and
none of an earlier frame's, and before the check reads them.  The traced
frames then start with a cadence frame and end before one: each job they
dispatch runs beside the frames after it, as it does untraced.  ``MapLog``
keeps the map stage's fusions and merges in the program's order and
``MeshReturns`` the frames at which an async extraction returned.
"""

from __future__ import annotations

import functools
import gc
import json
import random
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import discovery
from .reference import render

BANNED = ("jax", "jaxlib", "flax", "nerf_fusion_tpu")
# cadences the check's interval may run on past its second, waiting for an
# async extraction it dispatched to return
RUN_ON = 4


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


class Frames:
    """The frame each piece of the program's work belongs to.  The loop's
    thread works in the frame the harness set last (``loop``); a job on the
    map's worker (``system/worker.py``) belongs to the frame that submitted
    it: ``Worker.submit`` is wrapped, and the job's thread reads that frame
    while the job runs.  ``jobs``: (frame, kind) of each job submitted,
    ``"refine"`` or ``"mesh"``."""

    def __init__(self):
        import nerf_fusion_tpu_torch.system.worker as worker_mod

        self.cls, self.orig = worker_mod.Worker, worker_mod.Worker.submit
        self.loop, self.jobs, self._pending, self._local = None, [], [], threading.local()
        frames = self

        def submit(worker, fn, *a, **k):
            fid = frames.loop

            @functools.wraps(fn)
            def job(*ja, **jk):
                frames._local.frame = fid
                try:
                    return fn(*ja, **jk)
                finally:
                    frames._local.frame = None

            fut = frames.orig(worker, job, *a, **k)
            kind = "mesh" if "Mesher" in getattr(fn, "__qualname__", "") else "refine"
            frames.jobs.append((fid, kind))
            # a finished future holds its result (a refinement's buffers): keep none
            frames._pending = [f for f in frames._pending if not f.done()] + [fut]
            return fut

        worker_mod.Worker.submit = submit

    def now(self):
        f = getattr(self._local, "frame", None)
        return self.loop if f is None else f

    def wait(self):
        """Wait until every job submitted so far has ended, without
        collecting it: the program merges and returns it where it would."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.exception()

    def close(self):
        self.cls.submit = self.orig


class ExtractTap:
    """Each result of the mesher's ``fused_extract`` while installed, with
    the frame it belongs to (``Frames``), and the ``decoder_forward``
    launches inside it."""

    def __init__(self, frames: Frames, keep_all: bool):
        import nerf_fusion_tpu_torch.system.mesher as mesher_mod
        from nerf_fusion_tpu_torch.ops import launches

        self.mod = mesher_mod
        self.orig = mesher_mod.fused_extract
        self.calls = []

        def fused_extract(*a, **k):
            before = launches.snapshot()
            out = self.orig(*a, **k)
            n = launches.diff(launches.snapshot(), before)["decoder_forward"]
            # (result, mesh ids, keep, ...): a traced frame keeps the mask alone,
            # so that no mesh buffer outlives its frame
            self.calls.append((frames.now(), out if keep_all else (None, None, out[2]), n))
            return out

        mesher_mod.fused_extract = fused_extract

    def close(self):
        self.mod.fused_extract = self.orig


class RefineTap:
    """Each latent refinement of the map while installed, with the frame it
    belongs to (``Frames``: with ``run_async`` the frame that dispatched
    it): wraps ``system.refine.refine_latents_core``, which the map and the
    async refiner reach through the module, and ``refine_targets``, which
    the core calls.  ``keep``:

    * ``"rows"`` (traced frames): (frame id, the pairs that count as a
      device tensor, ``n_iters``) in ``calls``; no host read;
    * ``"check"``: a dict a call in ``calls``: the jitter, ``n_iters``,
      ``code_reg_lambda``, the refined slots and latents, the mean NLL a
      step (the map's log) and the ``RefineResult`` itself;
    * ``"best"`` (set-up): the same for the call with the most eligible
      voxels only, in ``best``, with a copy of the state passed in; the
      count is read on the host after each call."""

    def __init__(self, frames: Frames, keep: str):
        import nerf_fusion_tpu_torch.system.refine as refine_mod

        self.mod, self.keep = refine_mod, keep
        self.orig, self.orig_targets = refine_mod.refine_latents_core, refine_mod.refine_targets
        self.calls, self.best = [], None
        made = threading.local()

        def refine_targets(*a, **k):
            made.last = self.orig_targets(*a, **k)
            return made.last

        # the map passes n_iters, code_reg_lambda and its log by keyword
        def core(state, cfg, decoder, points, normals, valid, gt_sdf, **k):
            made.last = None
            res = self.orig(state, cfg, decoder, points, normals, valid, gt_sdf, **k)
            fid = frames.now()
            if self.keep == "rows":
                pairs = made.last.weight.sum() if made.last is not None else None
                self.calls.append((fid, pairs, int(k["n_iters"])))
                return res
            rec = {"frame_id": fid, "gt": gt_sdf, "n_iters": int(k["n_iters"]),
                   "code_reg_lambda": float(k["code_reg_lambda"]), "refined": res.refined,
                   "latents": res.latents, "nll": (k.get("log") or {}).get("nll")}
            if self.keep == "check":
                self.calls.append(dict(rec, result=res))
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


class MapLog:
    """The map stage's steps in the order the program made them, each with
    its frame: ``("fuse", frame)`` for each integration
    (``system.map.integrate_keyframe``, the module's function) and
    ``("merge", frame, result, deintegrate)`` for each refinement merged
    into the map (``system.refine.merge_refined``)."""

    def __init__(self, frames: Frames):
        import nerf_fusion_tpu_torch.system.map as map_mod
        import nerf_fusion_tpu_torch.system.refine as refine_mod

        self.map_mod, self.refine_mod = map_mod, refine_mod
        self.orig_fuse, self.orig_merge = map_mod.integrate_keyframe, refine_mod.merge_refined
        self.steps = []

        def fuse(*a, **k):
            self.steps.append(("fuse", frames.now()))
            return self.orig_fuse(*a, **k)

        def merge(state, res, deintegrate):
            self.steps.append(("merge", frames.now(), res, bool(deintegrate)))
            return self.orig_merge(state, res, deintegrate)

        map_mod.integrate_keyframe = fuse
        refine_mod.merge_refined = merge

    def close(self):
        self.map_mod.integrate_keyframe = self.orig_fuse
        self.refine_mod.merge_refined = self.orig_merge


class MeshReturns:
    """The frames at which an async ``Mesher.extract`` call returned the
    triangles of the extraction that ran last (``returned``); the frame that
    dispatched it is the latest mesh job before (``Frames.jobs``)."""

    def __init__(self, frames: Frames):
        from nerf_fusion_tpu_torch.system.mesher import Mesher

        self.cls, self.orig, self.frames = Mesher, Mesher.extract, frames
        self.returned = []

        def extract(mesher, *a, **k):
            out = self.orig(mesher, *a, **k)
            if k.get("extract_async") and out is not None:
                self.returned.append(frames.now())
            return out

        Mesher.extract = extract

    def lags(self) -> list:
        """(dispatch frame, return frame) of each returned extraction."""
        dispatched = sorted(f for f, kind in self.frames.jobs if kind == "mesh")
        out = []
        for r in self.returned:
            d = [f for f in dispatched if f < r]
            if d:
                out.append((d[-1], r))
        return out

    def close(self):
        self.cls.extract = self.orig


def frame_copy(pipe, frame_id: int) -> dict:
    """A copy of the map state and of the processed cloud as the frame
    ``frame_id`` left them, and its pose."""
    st = pipe.map.state
    return {"frame_id": frame_id, "state": {k: getattr(st, k).clone() for k in st._fields},
            "cloud": tuple(x.clone() for x in pipe.tracker.last_processed_pc),
            "pose": pipe.tracker.all_pd_pose[frame_id]}


class Capture:
    """What the check reads: after each cadence frame a copy of the map
    state and of the frame's processed cloud; each mesh batch
    (``fused_extract``'s result) and, with ``refine``, each refinement
    (``RefineTap``), by the frame that dispatched it; the map stage's steps
    (``MapLog``)."""

    def __init__(self, frames: Frames, refine: bool = False):
        self.tap = ExtractTap(frames, keep_all=True)
        self.refine = RefineTap(frames, "check") if refine else None
        self.map_log = MapLog(frames)
        self.cadences = []

    def close(self):
        self.tap.close()
        self.map_log.close()
        if self.refine is not None:
            self.refine.close()

    def after_cadence(self, pipe, frame_id: int):
        self.cadences.append(frame_copy(pipe, frame_id))

    def batches(self):
        """Each cadence's mesh batch, the last extraction it dispatched."""
        for c in self.cadences:
            batch = next((out for f, out, _ in reversed(self.tap.calls)
                          if f == c["frame_id"]), None)
            c["batch"] = None if batch is None else (batch[1], batch[2], batch[0])


class GroupCounter:
    """Evaluations of each GN group of each tracked frame, by frame id
    (``by_frame``): wraps the tracker's host loop, ``run_groups``.
    Installed over the traced frames and the check's interval only."""

    def __init__(self, frames: Frames):
        import nerf_fusion_tpu_torch.system.tracker as tracker_mod

        self.mod = tracker_mod
        self.orig = tracker_mod.run_groups
        self.by_frame = {}

        def run_groups(tcfg, state, iteration):
            counts = [0] * len(tcfg.iter_config)

            def counted(group):
                counts[group] += 1
                return iteration(group)

            out = self.orig(tcfg, state, counted)
            self.by_frame[frames.now()] = counts
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
    frames = Frames()
    run_async = bool(fusion.get("run_async", False))

    def step(fid):
        frames.loop = fid
        pipe.process_frame(traffic.frame(fid), fid, use_gt_pose=traffic.posed)

    # set-up: the warm-up cycles; with refinement the one of most eligible
    # voxels is kept for the check, with its frame's cloud and pose, and its
    # state before it: run in place, the tap's copy; run on the worker, the
    # map as the frame that dispatched it left it (``frame_copy``), kept for
    # the last frame that dispatched one and for the best so far
    refining = bool(fusion.get("do_optimize", False))
    setup_tap = RefineTap(frames, "best") if refining else None
    copies = {}
    n_warm = int(traffic_spec["warm_cycles"]) * len(traffic.order)
    for fid in range(n_warm):
        n_jobs = len(frames.jobs)
        step(fid)
        best = setup_tap.best if setup_tap is not None else None
        if run_async and refining:
            if any(kind == "refine" for _, kind in frames.jobs[n_jobs:]):
                copies = {f: c for f, c in copies.items()
                          if best is not None and f == best["frame_id"]}
                copies[fid] = frame_copy(pipe, fid)
        elif best is not None and best["frame_id"] == fid and "cloud" not in best:
            best["cloud"] = tuple(x.clone() for x in pipe.tracker.last_processed_pc)
            best["pose"] = pipe.tracker.all_pd_pose[fid]
    # no job of set-up runs on into the window
    frames.wait()
    if setup_tap is not None:
        setup_tap.close()
        if setup_tap.best is not None and setup_tap.best["frame_id"] in copies:
            setup_tap.best.update(copies[setup_tap.best["frame_id"]])
    del copies
    fid = n_warm
    pipe.mesher.current_mesh()
    sync()

    # -- the window ---------------------------------------------------------
    n_trace = int(traffic_spec["trace_cycles"]) * cadence
    # the traced frames are whole cycles: run in place, a cycle ends with the
    # cadence frame that integrates and meshes; run on the worker, it starts
    # with it, and its jobs run on beside the frames after it
    first = 0 if run_async else 1
    cuda = dev.type == "cuda"
    events, frame_ids, traced = [], [], []
    prof = trace_info = counter = tap = rtap = None
    returns = MeshReturns(frames) if run_async else None
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
        if trace and prof is None and trace_from is None and fid % cadence == first \
                and time.perf_counter() - t0 >= 0.3 * seconds:
            trace_from = fid
            # the traced frames hold every kernel of the jobs they dispatch
            # and none of an earlier frame's: the last cadence's jobs, which
            # have as a rule ended by the next, are waited for here
            frames.wait()
            sync()
            from torch.profiler import ProfilerActivity, profile

            counter, tap = GroupCounter(frames), ExtractTap(frames, keep_all=False)
            rtap = RefineTap(frames, "rows") if refining else None
            # the device's activity and the host's CUDA calls only: recording every
            # host operator would slow the host, which paces these frames
            acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
            prof = profile(activities=acts)
            prof.__enter__()
            per_frame, sizes, snap = [], [], launches.snapshot()
        tracing = prof is not None and trace_info is None
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
            frames.wait()
            sync()
            prof.__exit__(None, None, None)
            # what the last frame's jobs launched while the harness waited
            # for them is that frame's
            now = launches.snapshot()
            per_frame[-1] = {k: v + per_frame[-1][k]
                             for k, v in launches.diff(now, snap).items()}
            counter.close()
            tap.close()
            if rtap is not None:
                rtap.close()
            traced_ids = list(range(trace_from, trace_from + n_trace))
            trace_info = {
                "frames": traced_ids, "launches": per_frame, "async": run_async,
                "groups": [counter.by_frame[f] for f in traced_ids if f in counter.by_frame],
                "sizes": sizes, "extractions": tap.calls,
                "refines": rtap.calls if rtap is not None else []}
        fid += 1
        if time.perf_counter() - t0 >= seconds and (prof is None or trace_info is not None):
            break
    # the window's work is done once the jobs its frames dispatched are
    frames.wait()
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
    # the window's refinements: the entries its frames added to the program's
    # own log, one a dispatch, their events read now that each has ended
    window_refines = [{"ms": e["clock"].ms(), "eligible": int(e["eligible"]),
                       "sampled": int(e["sampled"])}
                      for e in pipe.map.refine_log[refines0:refines1]]
    refine_info = {"n_iters": int(pipe.map.optim_n_iters), "count": refines1 - refines0,
                   **{k: [e[k] for e in window_refines] for k in ("ms", "eligible", "sampled")}}
    if window_refines:
        log("refine: the window's {count} refinements: ms, eligible, sampled voxels "
            "(min / median / max) {r}".format(count=refine_info["count"], r=[
                (min(v), float(np.median(v)), max(v))
                for v in (refine_info[k] for k in ("ms", "eligible", "sampled"))]))

    mesh_lag = None if returns is None else [
        r - d for d, r in returns.lags() if frame_ids[0] <= d and r <= frame_ids[-1]]

    # -- the check's interval ------------------------------------------------
    # The same loop runs on, untimed, to the second cadence frame after the
    # window: the map and the cloud of both cadences, the map stage's steps,
    # the mesh batch and the refinements each dispatched, and the GN
    # evaluations of each frame between them are kept.  With ``run_async``
    # the loop runs on until an extraction that one of them dispatched has
    # returned its triangles (at most ``RUN_ON`` cadences more), then waits
    # for the worker's jobs.  Nothing of the check runs inside the window.
    capture, groups = Capture(frames, refine=refining), GroupCounter(frames)
    while True:
        step(fid)
        if fid % cadence == 0 and len(capture.cadences) < 2:
            capture.after_cadence(pipe, fid)
        fid += 1
        if len(capture.cadences) == 2 and (
                returns is None
                or any(d >= capture.cadences[0]["frame_id"] for d, _ in returns.lags())
                or fid > capture.cadences[1]["frame_id"] + RUN_ON * cadence):
            break
    frames.wait()
    sync()
    capture.batches()
    for part in (capture, groups, frames) + ((returns,) if returns is not None else ()):
        part.close()

    # -- what the check reads, then the program is freed --------------------
    # each frame's pose is a tensor of its own, which no later frame rewrites
    poses = list(pipe.tracker.all_pd_pose)
    found = banned_modules()
    ctx = {
        "config": config, "traffic": traffic_spec, "frame_ids": frame_ids, "interval_ms": ms,
        "traced": traced, "cadence": cadence, "window_s": window_s, "setup_s": setup_s,
        "trace": trace_info, "launches": launches.diff(launches1, launches0),
        "host_reads": reads1 - reads0, "occupied_voxels": occupied, "refine": refine_info,
        "mesh_lag": mesh_lag,
        "power_limit": power_limit() if cuda else "cpu",
    }
    cadences = capture.cadences
    refines = {"check": capture.refine.calls if refining else [],
               "setup": setup_tap.best if refining else None,
               "map_steps": capture.map_log.steps}
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
