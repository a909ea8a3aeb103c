"""Marching-cubes case tables, derived programmatically at import time.

Instead of embedding the classic Lorensen–Cline literal tables (as the
reference does in system/ext/marching_cubes/mc_data.cuh), we derive the
edge and triangle tables from first principles:

  * corner/edge layout is the standard MC cube (corner i at bit i);
  * a cell configuration's cut edges are those whose endpoints straddle the
    isosurface;
  * on every face the cut edges are paired by the rule "each *inside*
    corner keeps its two adjacent cut edges" — a deterministic function of
    the face's corner signs, so the two cells sharing a face always agree
    on the pairing.  This makes the generated surface **crack-free and
    watertight by construction** (classic MC tables, generated from 15 base
    cases by reflection, are not: their ambiguous-face resolutions can
    disagree across a shared face);
  * cut-edge cycles are walked across faces and fan-triangulated;
  * every loop is oriented so triangle normals point toward positive SDF
    (outside).

``test_mc.py`` verifies watertightness and outward orientation on random
smooth fields and a sphere.
"""

from __future__ import annotations

import numpy as np

# Corner i has coordinates CORNERS[i]; bit i of a configuration = corner i
# is inside (sdf < 0).
CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.float64)

# Edge e connects EDGE_CORNERS[e] = (a, b).
EDGE_CORNERS = np.array([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
], dtype=np.int64)

# Faces as cyclic corner quadruples.
_FACES = [
    (0, 1, 2, 3),   # z = 0
    (4, 5, 6, 7),   # z = 1
    (0, 1, 5, 4),   # y = 0
    (3, 2, 6, 7),   # y = 1
    (0, 3, 7, 4),   # x = 0
    (1, 2, 6, 5),   # x = 1
]


def _edge_between(a, b):
    for e, (x, y) in enumerate(EDGE_CORNERS):
        if {x, y} == {a, b}:
            return e
    raise ValueError((a, b))


_FACE_EDGES = [[_edge_between(f[i], f[(i + 1) % 4]) for i in range(4)] for f in _FACES]
_EDGE_FACES = [[] for _ in range(12)]
for fi, fe in enumerate(_FACE_EDGES):
    for e in fe:
        _EDGE_FACES[e].append(fi)


def _face_pairing(face_idx, inside):
    """Pair the cut edges of one face. Returns {edge: partner_edge}."""
    corners = _FACES[face_idx]
    edges = _FACE_EDGES[face_idx]
    cut = [e for e in edges if inside[EDGE_CORNERS[e][0]] != inside[EDGE_CORNERS[e][1]]]
    if len(cut) == 0:
        return {}
    if len(cut) == 2:
        return {cut[0]: cut[1], cut[1]: cut[0]}
    # 4 cut edges: two diagonal inside corners; each keeps its adjacent edges.
    pairing = {}
    for c in corners:
        if inside[c]:
            adj = [e for e in cut if c in EDGE_CORNERS[e]]
            assert len(adj) == 2
            pairing[adj[0]] = adj[1]
            pairing[adj[1]] = adj[0]
    return pairing


def _loops_for_config(config):
    inside = [(config >> i) & 1 == 1 for i in range(8)]
    cut = {e for e in range(12)
           if inside[EDGE_CORNERS[e][0]] != inside[EDGE_CORNERS[e][1]]}
    pairing = {fi: _face_pairing(fi, inside) for fi in range(6)}
    loops = []
    unvisited = set(cut)
    while unvisited:
        start = min(unvisited)
        face = _EDGE_FACES[start][0]
        loop = []
        e = start
        while True:
            loop.append(e)
            unvisited.discard(e)
            partner = pairing[face][e]
            f0, f1 = _EDGE_FACES[partner]
            face = f1 if f0 == face else f0
            e = partner
            if e == start:
                break
        loops.append(loop)
    # Orient each loop: normal should point toward outside (positive sdf).
    oriented = []
    for loop in loops:
        pts = np.array([CORNERS[EDGE_CORNERS[e][0]] + CORNERS[EDGE_CORNERS[e][1]]
                        for e in loop]) * 0.5
        # Newell's method polygon normal.
        n = np.zeros(3)
        for i in range(len(pts)):
            p, q = pts[i], pts[(i + 1) % len(pts)]
            n += np.cross(p, q)
        # Direction from inside corners to outside corners along the loop.
        d = np.zeros(3)
        for e in loop:
            a, b = EDGE_CORNERS[e]
            if inside[a]:
                d += CORNERS[b] - CORNERS[a]
            else:
                d += CORNERS[a] - CORNERS[b]
        if np.dot(n, d) < 0:
            loop = loop[::-1]
        oriented.append(loop)
    return oriented


def _build_tables():
    edge_table = np.zeros(256, dtype=np.int32)
    tri_rows = []
    max_len = 0
    for config in range(256):
        inside = [(config >> i) & 1 == 1 for i in range(8)]
        for e in range(12):
            a, b = EDGE_CORNERS[e]
            if inside[a] != inside[b]:
                edge_table[config] |= (1 << e)
        tris = []
        for loop in _loops_for_config(config):
            for i in range(1, len(loop) - 1):
                tris.extend([loop[0], loop[i], loop[i + 1]])
        tri_rows.append(tris)
        max_len = max(max_len, len(tris))
    n_tri_max = max_len // 3
    tri_table = np.full((256, max_len), -1, dtype=np.int32)
    tri_count = np.zeros(256, dtype=np.int32)
    for config, tris in enumerate(tri_rows):
        tri_table[config, :len(tris)] = tris
        tri_count[config] = len(tris) // 3
    return edge_table, tri_table, tri_count, n_tri_max


EDGE_TABLE, TRI_TABLE, TRI_COUNT, MAX_TRIS_PER_CELL = _build_tables()
