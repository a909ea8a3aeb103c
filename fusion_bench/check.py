"""The comparison that decides ``correct``.

It reads one cadence interval of the run: the window's loop runs on,
untimed, to the second cadence frame after the window's close, so that
nothing of the check runs inside the window.  The map state after the first
of those cadence frames (``prev``) and after the second (``last``), the
second's processed cloud and mesh batch, and the program's poses and GN
evaluations of the frames between.  Each stage is recomputed by the plain
reference (``reference/``) from the inputs the program's stage had, in
float32:

* frontend: the last cadence frame's cloud from its rendered frame, row by
  row (``frontend_numbers``);
* tracker: ``n_track_samples`` frames drawn from the seed among those
  tracked against ``prev``, each from the program's pose of the frame
  before it (in a posed cell: every pose of the window against the pose
  handed in, exactly);
* map: ``prev`` integrated with the program's cloud and pose of the last
  cadence frame, against ``last``; where the configuration refines
  (``do_optimize``), integrated and then refined with the program's jitter
  of that cadence (``refine_numbers``); with ``run_async`` the last
  cadence replayed in the program's order, its fusion and the merges the
  async split allows (``replay_cadence``), and each refinement the two
  cadences dispatched, from the map its frame left;
* refinement from set-up: the one of most eligible voxels, from the
  program's state before it, its frame's cloud and pose and its jitter;
* mesher: the batch of the last extraction the later of the two cadences
  dispatched, else the earlier, meshed from the map its frame left (the
  snapshot an async extraction reads).

Each number has its limit in ``limits.json``.  ``control``: the reference
computed one precision lower (``reference.precision.CONTROL``) is judged
the same way, against the float32 reference, in the program's place.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from .discovery import ROOT
from .reference import evaluate, frontend, mapping, mesh, refine, tracker
from .reference.model import Prior
from .reference.precision import CONTROL, F32


def limits() -> dict:
    with open(ROOT / "limits.json") as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def _tcfg(tracking: dict) -> dict:
    sdf, rgb = tracking["sdf"], tracking["rgb"]
    return {"iter_config": tracking["iter_config"],
            "sdf_robust_kernel": sdf.get("robust_kernel"),
            "sdf_robust_k": float(sdf.get("robust_k", 1.0)),
            "rgb_robust_kernel": rgb.get("robust_kernel"),
            "rgb_robust_k": float(rgb.get("robust_k", 0.01)),
            "min_grad_scale": float(rgb.get("min_grad_scale", 0.0)),
            "max_depth_delta": float(rgb.get("max_depth_delta", 0.2)),
            "stride": int(rgb.get("stride", 1)),
            "scale_intrinsics": bool(rgb.get("scale_intrinsics", False)),
            "pixel_budget": int(rgb.get("pixel_budget", 0)),
            "weight": float(rgb["weight"])}


def align_rows(keys_a, keys_b):
    """Row pairs (ia, ib) of two clouds whose box keys agree, and the rows
    whose box the other cloud lacks.  The keys of the valid rows ascend."""
    ka, kb = keys_a[keys_a >= 0], keys_b[keys_b >= 0]
    pos = torch.searchsorted(kb, ka).clamp_max(max(kb.shape[0] - 1, 0))
    found = (kb[pos] == ka) if kb.shape[0] else torch.zeros_like(ka, dtype=torch.bool)
    ia = torch.nonzero(keys_a >= 0).flatten()[found]
    ib = torch.nonzero(keys_b >= 0).flatten()[pos[found]]
    n = int(found.sum())
    return ia, ib, (ka.shape[0] - n) + (kb.shape[0] - n)


# A box's normal is compared where the data fix it: its pixels' normals
# agree (their mean is at least this long), and at each pixel the two
# smallest eigenvalues of the window's covariance lie apart (their gap over
# the largest; else the direction is free in a plane) and the view ray is
# not grazing (the cosine; else the sign that turns it to the camera is
# free).  Judged on the reference's conditioning (``frontend.box_filter``).
NORMAL_FIXED = (0.5, 0.05, 0.05)


def frontend_numbers(prog, ref, keys=None, conditioning=None, log=None) -> dict:
    """Gaps of the rows that hold the same box in both clouds.  ``prog`` and
    ``ref``: (points, normals, mask).  With ``keys`` (each side's box key a
    row) the rows are paired by box, else by position: the rows of both are
    in the order of the boxes' hashed keys, so where the boxes agree so do
    the rows, and a box that differs shows as a row mismatch or, shifting
    every later row, as a point gap of centimetres.  The normal gap is taken
    over the rows whose ``conditioning`` (the reference's) fixes the normal
    (``NORMAL_FIXED``)."""
    if keys is not None:
        ia, ib, mism = align_rows(*keys)
    else:
        both = torch.nonzero(prog[2] & ref[2]).flatten()
        ia = ib = both
        mism = int((prog[2] != ref[2]).sum())
    out = {"frontend_row_mismatch": float(mism)}
    if ia.shape[0] == 0:
        return dict(out, frontend_point_gap=math.inf, frontend_normal_gap=math.inf)
    dp = (prog[0][ia] - ref[0][ib]).abs().amax(1)
    dn = (prog[1][ia] - ref[1][ib]).abs().amax(1)
    fixed = torch.ones_like(dn, dtype=torch.bool)
    if conditioning is not None:
        fixed = torch.all(conditioning[ib] >= torch.as_tensor(
            NORMAL_FIXED, dtype=conditioning.dtype, device=conditioning.device), 1)
    worst = int(dn.argmax())
    if log is not None:
        cond = [round(float(c), 4) for c in conditioning[ib[worst]]] \
            if conditioning is not None else None
        log(f"check: frontend over {ia.shape[0]} rows, {int(fixed.sum())} with their normal "
            f"fixed: normal gap p99 {float(torch.quantile(dn.double(), 0.99)):.4g}, largest "
            f"{float(dn[worst]):.4g} at a row of conditioning {cond}")
    gap_n = float(dn[fixed].max()) if bool(fixed.any()) else 0.0
    return dict(out, frontend_point_gap=float(dp.max()), frontend_normal_gap=gap_n)


def map_numbers(prog: dict, ref: dict, refined=None) -> dict:
    """The latent gap over the slots not ``refined`` (all where None:
    ``refine_numbers`` judges the others) and the slots that differ."""
    mism = int((prog["positions"] != ref["positions"]).sum()) \
        + int((prog["obs_count"] != ref["obs_count"]).sum()) \
        + int((prog["indexer"] != ref["indexer"]).sum()) \
        + abs(int(prog["n_occupied"]) - int(ref["n_occupied"]))
    gap = (prog["latents"] - ref["latents"]).abs()
    if refined is not None:
        gap = gap[~refined]
    return {"map_latent_gap": float(gap.max()) if gap.numel() else 0.0,
            "map_slot_mismatch": float(mism)}


# A refined latent is compared by the median of its components' gaps, not
# by the largest or a high quantile: Adam's first step is lr g / (|g| + eps),
# about +-lr whatever |g|, so a component whose gradient sits at rounding
# level can take either sign and move by up to 2 lr, and later steps carry
# it on; the program's latent gradient is an index_add_ with atomics, whose
# order differs from run to run.  The float32 reference reads the same tail
# against a float64 one (a tenth of a percent of the components at 1e-3 to
# 1e-2), while the median stays at rounding and moves with any fault that
# shifts the refinement as a whole.
REFINE_QUANTILE = 0.5


def refine_numbers(prog: dict, ref: dict) -> dict:
    """One refinement, the program's against the reference's.  Each side:
    ``eligible`` (C,), ``latents`` (C, L) after it, ``nll`` (n_iters,) the
    mean NLL before each step.  The slots whose eligibility differs; the
    largest gap of the mean NLLs over max(|NLL|, 1) (inf where the step
    counts differ); the ``REFINE_QUANTILE`` quantile (nearest rank) of the
    component gaps over the slots either side refined (0 where none)."""
    if prog is None:
        return {"refine_eligible_mismatch": math.inf, "refine_nll_gap": math.inf,
                "refine_latent_gap": math.inf}
    mism = int((prog["eligible"] != ref["eligible"]).sum())
    pn, rn = prog["nll"], ref["nll"]
    if pn is None or pn.shape != rn.shape:
        nll_gap = math.inf
    else:
        # relative where |NLL| >= 1, absolute below: a cadence's mean NLL over
        # few pairs can cross 0, where a relative gap has no scale
        nll_gap = float(((pn.double() - rn.double()).abs()
                         / rn.double().abs().clamp_min(1.0)).max()) if rn.numel() else 0.0
    both = prog["eligible"] | ref["eligible"]
    gap = torch.sort((prog["latents"][both] - ref["latents"][both]).abs().flatten().double()).values
    at = lambda q: float(gap[max(math.ceil(q * gap.numel()) - 1, 0)]) if gap.numel() else 0.0
    return {"refine_eligible_mismatch": float(mism), "refine_nll_gap": nll_gap,
            "refine_latent_gap": at(REFINE_QUANTILE),
            # logged beside it: the gaps' spread and the components compared
            "refine_latent_quantiles": [at(q) for q in (0.5, 0.9, 0.99, 0.995, 0.999, 1.0)],
            "refine_latent_components": float(gap.numel()),
            "refine_nlls": [None if pn is None else pn.tolist(), rn.tolist()]}


def _merge_worst(readings: dict, numbers: dict, tag: str):
    """The worse of the two refinements' readings of each number; what is
    only logged, under ``<name>.<tag>``."""
    for k, v in numbers.items():
        if isinstance(v, float):
            readings[k] = max(readings.get(k, -math.inf), v)
        else:
            readings[f"{k}.{tag}"] = v


def replay_cadence(prior, state: dict, mcfg: dict, steps: list, frame: int, jobs: list,
                   cloud, pose, prec, log=None) -> dict:
    """The map after the cadence frame ``frame`` of an async run, rebuilt
    from ``state``, the map before it, in the program's order: ``steps``
    (``harness.MapLog``: its fusions and merges, each with its frame, from
    the interval's start) replayed where they fall in ``frame``, the fusion
    with the frame's ``cloud`` at its ``pose``, each merge by the plain
    de-integration merge (``reference.refine.merge_async``) of the
    program's ``RefineResult``.  A merge is replayed only where the async
    split allows it: a de-integration merge of a refinement that an earlier
    frame of the interval dispatched (``jobs``: ``harness.RefineTap``'s
    records, keyed by the frame that dispatched each) and no step merged
    before.  Any other merge (its own frame's refinement, one merged twice,
    one the check did not see dispatched, or one merged in place) is left
    out, so that what it moved shows in ``map_latent_gap``."""
    merged = set()
    for step in steps:
        if step[0] == "fuse":
            if step[1] == frame:
                state = mapping.integrate(prior, state, mcfg, *cloud, *pose, prec)
            continue
        _, at, res, deintegrate = step
        job = next((j for j in jobs if j["result"] is res), None)
        ok = job is not None and deintegrate and job["frame_id"] < at \
            and id(job) not in merged
        if job is not None:
            merged.add(id(job))
        if at != frame:
            continue
        if log is not None:
            what = f"of frame {job['frame_id']}" if job is not None else "not seen dispatched"
            log(f"check: frame {frame} merges the refinement {what} "
                f"({int(res.refined.sum())} slots): {'replayed' if ok else 'left out'}")
        if ok:
            state = refine.merge_async(state, res.latents, res.refined, res.old_latents,
                                       res.old_counts)
    return state


def _async_map_stage(prior, mcfg, rcfg, cadences, poses, refines, precs, readings, log):
    """With ``run_async`` the map stage: the last cadence replayed from the
    one before (``replay_cadence``) and judged over every slot; each
    refinement the two cadences dispatched, against the reference's from
    the map its frame left (the snapshot the worker should read), that
    frame's cloud and pose and the program's jitter."""
    prev, last = cadences[-2], cadences[-1]
    jobs = refines.get("check", [])
    steps = refines.get("map_steps", [])
    pose = poses[last["frame_id"]]
    for name, prec in precs:
        ref = replay_cadence(prior, prev["state"], mcfg, steps, last["frame_id"], jobs,
                             last["cloud"], pose, F32, log if name == "program" else None)
        got = last["state"] if name == "program" else replay_cadence(
            prior, prev["state"], mcfg, steps, last["frame_id"], jobs, last["cloud"], pose, prec)
        readings[name].update(map_numbers(got, ref))
    by_frame = {c["frame_id"]: c for c in (prev, last)}
    checked = [j for j in jobs if j["frame_id"] in by_frame]
    if not checked:
        log("check: no refinement dispatched in the interval")
        for name, _ in precs:
            _merge_worst(readings[name], refine_numbers(None, None), "cadence")
    for job in checked:
        c = by_frame[job["frame_id"]]
        pts, nrm, mask = c["cloud"]
        R, t = poses[job["frame_id"]]
        ref = refine.refine(prior, c["state"], mcfg, rcfg, pts, nrm, mask, R, t, job["gt"], F32)
        log(f"check: async refinement dispatched in frame {job['frame_id']}: "
            f"{int(ref['eligible'].sum())} eligible, {ref['sampled']} sampled voxels, "
            f"{ref['pairs']} pairs, from the map that frame left")
        for name, prec in precs:
            side = {"eligible": job["refined"], "latents": job["latents"], "nll": job["nll"]} \
                if name == "program" else refine.refine(prior, c["state"], mcfg, rcfg, pts, nrm,
                                                        mask, R, t, job["gt"], prec)
            nums = refine_numbers(side, ref)
            log(f"check: async refinement of frame {job['frame_id']} ({name}) {nums}")
            _merge_worst(readings[name], nums, f"cadence{job['frame_id']}")


def pose_numbers(prog: list, ref: list, same_evals: list) -> dict:
    """Translation (m) and rotation (rad) gaps of the sampled frames: their
    medians, and their largest over the frames that ran as many GN
    evaluations in each group as the reference (0 where none did).  Where
    the counts differ, a step the "energy worse" test accepted on one side
    was rejected on the other, and the gap is that decision's, not
    rounding's: the median holds those frames."""
    gt, gr = [], []
    for (Rp, tp), (Rr, tr) in zip(prog, ref):
        gt.append(float(torch.linalg.vector_norm(tp.double() - tr.double())))
        # the angle between them to first order, free of the arccos's floor
        gr.append(float(torch.linalg.matrix_norm(Rp.double() - Rr.double())) / math.sqrt(2.0))
    same = [i for i, s in enumerate(same_evals) if s]
    return {"pose_gap_t": max(gt), "pose_gap_r": max(gr),
            "pose_gap_t_median": float(np.median(gt)), "pose_gap_r_median": float(np.median(gr)),
            "pose_gap_t_same_evals": max((gt[i] for i in same), default=0.0),
            "pose_gap_r_same_evals": max((gr[i] for i in same), default=0.0),
            "pose_frames_same_evals": float(len(same)), "pose_gaps_t": gt}


def _nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each row of ``a`` (N, 3) the distance to the nearest row of ``b``."""
    out = torch.empty(a.shape[0], dtype=torch.float64, device=a.device)
    for s in range(0, a.shape[0], 4096):
        out[s:s + 4096] = torch.cdist(a[s:s + 4096], b).amin(1)
    return out


def mesh_numbers(prog, ref) -> dict:
    """The 99th percentile of the distance from each vertex of one mesh to
    the nearest vertex of the other, the larger of the two directions: a
    vertex moved or a triangle missing shows; a cell whose configuration
    flips on a corner sample at zero, a discrete effect of rounding, does
    not reach the percentile."""
    pv = prog[0].reshape(-1, 3).double()
    rv = ref[0].reshape(-1, 3).double()
    if pv.shape[0] == 0 or rv.shape[0] == 0:
        return {"mesh_vertex_gap": 0.0 if pv.shape[0] == rv.shape[0] else math.inf,
                "mesh_triangles": [int(prog[0].shape[0]), int(ref[0].shape[0])]}
    gap = max(float(torch.quantile(_nearest(pv, rv), 0.99)),
              float(torch.quantile(_nearest(rv, pv), 0.99)))
    return {"mesh_vertex_gap": gap,
            "mesh_triangles": [int(prog[0].shape[0]), int(ref[0].shape[0])]}


def run(config: dict, traffic, cadences: list, poses: list, window_ids: list, dev,
        log=print, control: bool = False, program_evals: dict = None, refines: dict = None):
    """``cadences``: the two cadence frames' captures (``harness.Capture``),
    the frames between them tracked against the first's map;
    ``program_evals``: the program's GN evaluations of each group by frame
    id, for those frames; ``window_ids``: the window's frames (the posed
    poses and the quality log); ``refines``: the program's refinements
    (``harness.RefineTap``), ``check`` those of the interval by the frame
    that dispatched each, ``setup`` the set-up's of most eligible voxels,
    ``map_steps`` the interval's fusions and merges (``harness.MapLog``).

    (checks {name: [value, limit]}, failed count, readings by side); with
    ``control`` the checks are the control's, the program's logged beside."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lim = limits()
    fusion, ref_cfg = config["fusion"], config["reference"]
    prior = Prior(ROOT / config["prior"]["dir"], int(config["prior"]["epoch"]), dev)
    mcfg = mapping.map_cfg_of(fusion["mapping"], prior.enc[-1][0].shape[1])
    tcfg = _tcfg(fusion["tracking"])
    fcfg = dict(ref_cfg["frontend"], **fusion["tracking"].get("preprocess", {}))
    fcfg.update(depth_cut_min=fusion["depth_cut_min"],
                depth_cut_max=fusion["depth_cut_max"],
                subsample=float(fusion["tracking"]["sdf"].get("subsample", 0.5)))
    capacity = int(fusion["mapping"]["points_capacity"])
    if len(cadences) < 2:
        log("check: no whole cadence interval to check")
        return {"cadence_interval": [math.inf, 0.0]}, 1, {}
    prev, last = cadences[-2], cadences[-1]
    precs = [("program", F32)] + ([("control", CONTROL)] if control else [])
    readings = {name: {} for name, _ in precs}

    def frame(fid):
        i = traffic.index(fid)
        return traffic.rgb[i], traffic.depth[i]

    def pre(fid, prec):
        return frontend.preprocess(*frame(fid), traffic.calib, fcfg, capacity, prec)

    # frontend
    ref = pre(last["frame_id"], F32)
    ref_cloud = (ref["points"], ref["normals"], ref["mask"])
    for name, prec in precs:
        # the program's rows by position, the control's by box key
        if name == "program":
            got, keys = last["cloud"], None
        else:
            c = pre(last["frame_id"], prec)
            got, keys = (c["points"], c["normals"], c["mask"]), (c["keys"], ref["keys"])
        readings[name].update(frontend_numbers(got, ref_cloud, keys, ref["conditioning"],
                                               lambda m, n=name: log(f"{m} ({n})")))

    # map: the last cadence's integration from the state before it, and its
    # refinement with the program's jitter
    pts, nrm, mask = last["cloud"]
    R, t = poses[last["frame_id"]]
    refining = bool(fusion.get("do_optimize", False))
    rcfg = config.get("refine")
    refines = refines or {}
    if refining and fusion.get("run_async", False):
        _async_map_stage(prior, mcfg, rcfg, cadences, poses, refines, precs, readings, log)
    else:
        ref_map = mapping.integrate(prior, prev["state"], mcfg, pts, nrm, mask, R, t, F32)
        if refining:
            rec = next((r for r in refines.get("check", [])
                        if r["frame_id"] == last["frame_id"]), None)
            # without the program's jitter the reference refines with none
            jitter = rec["gt"] if rec is not None else torch.zeros(
                (pts.shape[0], 8), dtype=torch.float32, device=pts.device)
            ref_map = refine.refine(prior, ref_map, mcfg, rcfg, pts, nrm, mask, R, t, jitter, F32)
            log(f"check: refinement of frame {last['frame_id']}: "
                f"{int(ref_map['eligible'].sum())} eligible, {ref_map['sampled']} sampled "
                f"voxels, {ref_map['pairs']} pairs; the program's jitter: mean "
                f"{float(jitter.mean()):.3g}, std {float(jitter.std()):.5g}; "
                f"its n_iters, code_reg_lambda: "
                f"{(rec['n_iters'], rec['code_reg_lambda']) if rec is not None else None}")
        for name, prec in precs:
            if name == "program":
                got = last["state"]
            else:
                got = mapping.integrate(prior, prev["state"], mcfg, pts, nrm, mask, R, t, prec)
                if refining:
                    got = refine.refine(prior, got, mcfg, rcfg, pts, nrm, mask, R, t, jitter, prec)
            refined = None
            if refining:
                side = None if rec is None else {
                    "eligible": rec["refined"] if name == "program" else got["eligible"],
                    "latents": got["latents"],
                    "nll": rec["nll"] if name == "program" else got["nll"]}
                refined = ref_map["eligible"] if side is None \
                    else ref_map["eligible"] | side["eligible"]
                nums = refine_numbers(side, ref_map)
                log(f"check: refinement of frame {last['frame_id']} ({name}) {nums}")
                _merge_worst(readings[name], nums, "cadence")
            readings[name].update(map_numbers(got, ref_map, refined))

    # refinement: the set-up's of most eligible voxels, from the program's
    # state before it (the map stage above checks the integration that made it)
    best = refines.get("setup")
    if refining:
        if best is None or "cloud" not in best:
            log("check: no refinement in set-up")
            for name, _ in precs:
                _merge_worst(readings[name], refine_numbers(None, None), "setup")
        else:
            bpts, bnrm, bmask = best["cloud"]
            Rb, tb = best["pose"]
            sref = refine.refine(prior, best["state"], mcfg, rcfg, bpts, bnrm, bmask, Rb, tb,
                                 best["gt"], F32)
            log(f"check: set-up refinement of frame {best['frame_id']}: "
                f"{int(sref['eligible'].sum())} eligible, {sref['sampled']} sampled voxels, "
                f"{sref['pairs']} pairs")
            for name, prec in precs:
                if name == "program":
                    side = {"eligible": best["refined"], "latents": best["latents"],
                            "nll": best["nll"]}
                else:
                    side = refine.refine(prior, best["state"], mcfg, rcfg, bpts, bnrm, bmask,
                                         Rb, tb, best["gt"], prec)
                nums = refine_numbers(side, sref)
                log(f"check: set-up refinement ({name}) {nums}")
                _merge_worst(readings[name], nums, "setup")

    # tracker
    if traffic.posed:
        gap = 0.0
        for fid in window_ids:
            T = traffic.pose(fid)
            Rg = torch.as_tensor(T[:3, :3], dtype=torch.float32, device=dev)
            tg = torch.as_tensor(T[:3, 3], dtype=torch.float32, device=dev)
            Rp, tp = poses[fid]
            gap = max(gap, float((Rp - Rg).abs().max()), float((tp - tg).abs().max()))
        for name, _ in precs:
            readings[name]["posed_pose_gap"] = gap if name == "program" else 0.0
    else:
        span = list(range(prev["frame_id"] + 1, last["frame_id"] + 1))
        picks = sorted(traffic.rng.sample(span, min(int(ref_cfg["n_track_samples"]),
                                                    len(span))))
        ref_poses = []
        got, same = ({name: [] for name, _ in precs} for _ in range(2))
        for fid in picks:
            cur, before = pre(fid, F32), pre(fid - 1, F32)
            Rl, tl = poses[fid - 1]
            args = (prior, prev["state"], mcfg, tcfg, traffic.calib)
            R_, t_, ev = tracker.track(*args, before, cur, Rl, tl, tcfg["weight"],
                                       int(ref_cfg["gn_points"]), F32)
            ref_poses.append((R_, t_))
            gap = float(torch.linalg.vector_norm(poses[fid][1].double() - t_.double()))
            log(f"check: frame {fid} GN evaluations by group: program "
                f"{program_evals.get(fid)}, reference {ev}; translation gap {gap:.3g} m")
            for name, prec in precs:
                if name == "program":
                    got[name].append(poses[fid])
                    same[name].append(list(program_evals.get(fid) or []) == list(ev))
                else:
                    c_cur, c_before = pre(fid, prec), pre(fid - 1, prec)
                    Rc, tc_, ev_c = tracker.track(*args, c_before, c_cur, Rl, tl,
                                                  tcfg["weight"], int(ref_cfg["gn_points"]),
                                                  prec)
                    got[name].append((Rc, tc_))
                    same[name].append(list(ev_c) == list(ev))
        for name, _ in precs:
            readings[name].update(pose_numbers(got[name], ref_poses, same[name]))

    # mesher
    src = last if last["batch"] is not None else prev
    if src["batch"] is None:
        log("check: no mesh batch in the two cadences")
        for name, _ in precs:
            readings[name]["mesh_vertex_gap"] = math.inf
    else:
        ids, keep, res = src["batch"]
        n = min(int(res.n_triangles), res.vertices.shape[0])
        r, max_std = int(fusion["resolution"]), float(fusion["max_std"])
        ref_mesh = mesh.extract(prior, src["state"], mcfg, ids, keep, r, max_std, F32)
        ref_mesh = (ref_mesh[0][:n], ref_mesh[1][:n])
        for name, prec in precs:
            if name == "program":
                got = (res.vertices[:n], res.flatten_id[:n])
            else:
                got = mesh.extract(prior, src["state"], mcfg, ids, keep, r, max_std, prec)
                got = (got[0][:n], got[1][:n])
            readings[name].update(mesh_numbers(got, ref_mesh))
        log(f"check: mesh batch of frame {src['frame_id']}: {n} triangles, "
            f"{int(keep.sum())} voxels")

    # quality against the rendered scene, logged only
    gt = np.stack([traffic.pose(f)[:3, 3] for f in window_ids])
    est = np.stack([poses[f][1].double().cpu().numpy() for f in window_ids])
    log(f"quality: window ATE {evaluate.ate_rmse(est, gt):.6g} m over {len(window_ids)} frames")
    if src["batch"] is not None:
        err = evaluate.mesh_abs_sdf(res.vertices[:n], traffic.spec["scene"])
        log(f"quality: mesh batch |SDF| {err:.6g} m")
    for name, _ in precs:
        for k, v in readings[name].items():
            log(f"reading {name} {k} {v!r}")
    judged = readings["control" if control else "program"]
    checks = {k: [v, lim[k]] for k, v in judged.items() if k in lim}
    failed = sum(1 for v, l in checks.values() if not v <= l)
    return checks, failed, readings
