"""A tracker's captured GN evaluation against the same functions run eagerly.

``graph_vs_eager(tracker, group)`` takes a tracker that has captured its
frame step (on the card, after its first tracked frame) and runs one
evaluation of group ``group`` at the current GN state and the last frame's
inputs twice: through the captured iteration graph and through
``system.tracker.build_Hg`` called eagerly.  On one frame the result is
deterministic, so the two (H, g, energy) must be bitwise equal.  The GN
state is left as it was, and the replay is not counted as a launch.
"""

from __future__ import annotations

from ..system.tracker import build_Hg


def graph_vs_eager(tracker, group: int):
    """((H, g, energy) of the captured graph, of the eager call)."""
    step = tracker._step
    if step is None or step.graphs is None:
        raise RuntimeError("graph_vs_eager: no captured frame step")
    saved = [x.clone() for x in tracker.gn]
    graph = step.graphs["iteration"][group]
    graph.graph.replay()
    got = [x.clone() for x in graph.out]
    for x, s in zip(tracker.gn, saved):
        x.copy_(s)
    eager = build_Hg(step.terms, tracker.tcfg.iter_config[group][1], tracker.gn.dR,
                     tracker.gn.dt)
    return got, [x.clone() for x in eager]
