"""The kernels' launch counters, read and moved together.

Every kernel wrapper counts its launches on itself (``mlp.decoder_forward.
launches``, ``gather.row_gather.launches_by_c`` per row width, ...).  A
wrapper called while a CUDA graph is captured counts a launch that has not
happened, and a replay of the graph launches its kernels without calling
any wrapper.  So the tracker takes ``snapshot()`` before a capture, keeps
``diff(snapshot(), before)`` as the graph's launches, takes them back with
``add(..., -1)`` and adds them once per replay: the counters then hold the
kernels that ran on the card.  ``counter_of`` names the counter of a
kernel in a profiler trace, so that a trace can be held to the counters.

The counters move under ``cuda_build.COUNT_LOCK``, so launches from worker
threads (the async mesher and refiner) are never lost.  A capture diffs
the counters of every thread, so a worker's launches must not fall inside
one: a worker holds ``EXCLUSIVE`` for its whole job and the tracker takes
it around each capture.
"""

from __future__ import annotations

import re
import threading

from . import cuda_build, gather, gn, mlp, photometric, sdf_term, stencil

EXCLUSIVE = threading.RLock()

_PLAIN = {
    "decoder_forward": mlp.decoder_forward,
    "decoder_forward_grad": mlp.decoder_forward_grad,
    "decoder_vjp": mlp.decoder_vjp,
    "encoder_forward": mlp.encoder_forward,
    "stencil_count": stencil.neighbor_count,
    "stencil_normals": stencil.normals_stencil,
    "stencil_frontend": stencil.frontend_points,
    "lane_gather": gather.lane_gather,
    "select_gather": gather.select_gather,
    "photometric_hg": photometric.photometric_hg,
    "gn_step": gn.gn_step,
    "sdf_rows": sdf_term.sdf_rows,
    "sdf_hg": sdf_term.sdf_hg,
}
# the row gather's counters, one per row width
ROW_GATHER = {f"row_gather_c{c}": c for c in gather.ROW_WIDTHS}
NAMES = tuple(_PLAIN) + tuple(ROW_GATHER)


def snapshot() -> dict:
    with cuda_build.COUNT_LOCK:
        counts = {name: fn.launches for name, fn in _PLAIN.items()}
        counts.update({name: gather.row_gather.launches_by_c[c]
                       for name, c in ROW_GATHER.items()})
    return counts


def diff(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in NAMES}


def add(counts: dict, times: int = 1):
    with cuda_build.COUNT_LOCK:
        for name, n in counts.items():
            if name in ROW_GATHER:
                gather.row_gather.launches_by_c[ROW_GATHER[name]] += times * n
            else:
                _PLAIN[name].launches += times * n


def reset():
    with cuda_build.COUNT_LOCK:
        for fn in _PLAIN.values():
            fn.launches = 0
        gather.reset_launches()


_KERNELS = (("decoder_kernel<false>", "decoder_forward"),
            ("decoder_kernel<true>", "decoder_forward_grad"),
            ("decoder_vjp_kernel", "decoder_vjp"),
            ("encoder_kernel", "encoder_forward"),
            ("photometric_kernel", "photometric_hg"),
            ("gn_step_kernel", "gn_step"),
            ("select_gather_kernel", "select_gather"),
            ("lane_gather_kernel", "lane_gather"),
            ("sdf_rows_kernel", "sdf_rows"),
            ("sdf_hg_kernel", "sdf_hg"))
# csrc/stencil.cu's Mode, as the trace prints it: ((anonymous namespace)::Mode)2
_STENCIL_MODES = {"0": "stencil_count", "1": "stencil_normals", "2": "stencil_frontend"}


def counter_of(kernel: str):
    """The counter of a kernel as a profiler trace names it (demangled), or
    None for a kernel of PyTorch's own."""
    for key, name in _KERNELS:
        if key in kernel:
            return name
    m = re.search(r"row_gather_kernel<(\d)[,>]", kernel)
    if m:
        return f"row_gather_c{m.group(1)}"
    m = re.search(r"stencil_kernel<\(\(anonymous namespace\)::Mode\)(\d)>", kernel)
    if m:
        return _STENCIL_MODES.get(m.group(1))
    return None
