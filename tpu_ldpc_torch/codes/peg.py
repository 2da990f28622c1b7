"""QC-PEG shift assignment: greedy girth-maximizing shift selection.

The anneal pipeline (codes/anneal.py) perturbs a random initial shift
table and descends a weighted cycle-count cost — it plateaus at small
lifts (Z=24) where the shift space is tiny and the cost surface is
rough (the two wimax z24 cells survived seven seeds and two degree
profiles).  This module is the classic alternative,
adapted to the QC setting: Progressive Edge Growth in the SHIFT domain.

Keep the committed table's SUPPORT (base-graph positions and therefore
the exact degree profile, which dominates finite-length FER), clear the
info-column shifts, and re-place them one edge at a time; for each edge
(i, j) pick the shift s whose new lifted edge closes the LONGEST
possible shortest cycle, computed by BFS over the current lifted Tanner
graph from the variable copy v_{j,0} (circulant symmetry makes copy 0
representative).  Ties break by (fewest shortest paths = fewest created
shortest cycles, lowest check-copy degree, rng).

A low-temperature joint ace6+ace8 anneal polish from the PEG point then
cleans up residual cycle structure without losing the greedy girth.

The port's copy of ``tpu_ldpc/codes/peg.py``: the same ``default_rng``
draws in the same order (``shuffle`` of the rows, ``choice`` among tied
shifts), so the same seed gives the same table.
"""

from __future__ import annotations

import numpy as np

from tpu_ldpc_torch.codes.base_graphs import count_4cycles


def _lifted_adj(B: np.ndarray, Z: int):
    """Adjacency lists of the lifted Tanner graph.

    Variable copy v_{j,a} connects to check copy c_{i,(a+s_ij) mod Z}
    for every placed entry s_ij >= 0 (the same circulant convention as
    codes/expand.py; girth is convention-independent).
    Returns (var_adj, chk_adj): var_adj[j][a] = list of (i, b) and
    chk_adj[i][b] = list of (j, a).
    """
    mb, nb = B.shape
    var_adj = [[[] for _ in range(Z)] for _ in range(nb)]
    chk_adj = [[[] for _ in range(Z)] for _ in range(mb)]
    for i in range(mb):
        for j in range(nb):
            s = B[i, j]
            if s < 0:
                continue
            for a in range(Z):
                b = (a + s) % Z
                var_adj[j][a].append((i, b))
                chk_adj[i][b].append((j, a))
    return var_adj, chk_adj


def _bfs_check_dists(B: np.ndarray, Z: int, j0: int):
    """BFS from v_{j0,0} over the current lifted graph.

    Returns (dist, npaths): dist[i, b] = edge distance from v_{j0,0}
    to check copy c_{i,b} (-1 if unreachable), npaths[i, b] = number of
    shortest paths (saturated at a large cap; used only to rank ties).
    """
    mb, nb = B.shape
    var_adj, chk_adj = _lifted_adj(B, Z)
    CAP = 1 << 30
    dv = -np.ones((nb, Z), np.int64)
    dc = -np.ones((mb, Z), np.int64)
    pv = np.zeros((nb, Z), np.int64)
    pc = np.zeros((mb, Z), np.int64)
    dv[j0, 0] = 0
    pv[j0, 0] = 1
    frontier_v = [(j0, 0)]
    d = 0
    while frontier_v:
        # expand variables -> checks
        frontier_c = []
        for (j, a) in frontier_v:
            for (i, b) in var_adj[j][a]:
                if dc[i, b] < 0:
                    dc[i, b] = d + 1
                    frontier_c.append((i, b))
                if dc[i, b] == d + 1:
                    pc[i, b] = min(pc[i, b] + pv[j, a], CAP)
        # expand checks -> variables
        frontier_v = []
        for (i, b) in frontier_c:
            for (j, a) in chk_adj[i][b]:
                if dv[j, a] < 0:
                    dv[j, a] = d + 2
                    frontier_v.append((j, a))
                if dv[j, a] == d + 2:
                    pv[j, a] = min(pv[j, a] + pc[i, b], CAP)
        d += 2
    return dc, pc


def peg_assign_shifts(
    B_template: np.ndarray,
    Z: int,
    seed: int = 0,
    frozen_cols: list[int] | None = None,
    col_order: str = "weight",
):
    """Re-assign the shifts of B_template's non-frozen columns by QC-PEG.

    B_template: shift table whose SUPPORT (>=0 positions) is kept; its
      shift values in non-frozen columns are discarded and re-chosen.
    frozen_cols: columns kept verbatim (default: the parity part, the
      last mb columns — same convention as anneal_shifts).
    col_order: 'weight' places heaviest info columns first (their edges
      are the hardest to keep cycle-free), 'index' goes left to right,
      'random' shuffles.

    Returns a new shift table of the same support.
    """
    B_template = np.asarray(B_template)
    mb, nb = B_template.shape
    if frozen_cols is None:
        frozen_cols = list(range(nb - mb, nb))
    frozen = set(frozen_cols)
    rng = np.random.default_rng(seed)

    B = np.where(
        np.isin(np.arange(nb), list(frozen))[None, :], B_template, -1
    ).astype(np.int64)

    cols = [j for j in range(nb) if j not in frozen]
    if col_order == "weight":
        cols.sort(key=lambda j: -(B_template[:, j] >= 0).sum())
    elif col_order == "random":
        rng.shuffle(cols)

    for j in cols:
        rows = [i for i in range(mb) if B_template[i, j] >= 0]
        rng.shuffle(rows)
        for i in rows:
            dc, pc = _bfs_check_dists(B, Z, j)
            # candidate shift s connects v_{j,0} to c_{i,s}: the cycle
            # closed through the new edge has length dc[i,s] + 1
            dist = dc[i]  # (Z,)
            # unreachable (-1) = tree edge = infinite girth: best class
            girth_key = np.where(dist < 0, np.int64(1 << 40), dist)
            best = girth_key.max()
            cand = np.flatnonzero(girth_key == best)
            if len(cand) > 1:
                # fewest shortest cycles created
                p = np.where(dist[cand] < 0, 0, pc[i][cand])
                cand = cand[p == p.min()]
            # NOTE: no degree-balancing tie-break exists in the QC shift
            # domain — a circulant contributes exactly one edge to EVERY
            # check copy of its block-row, so per-copy degrees within a
            # row are structurally uniform and can never discriminate
            # between candidate shifts.
            s = int(rng.choice(cand))
            B[i, j] = s
    assert ((B >= 0) == (B_template >= 0)).all()
    return B


def peg_candidate(
    B_committed: np.ndarray,
    Z: int,
    seed: int = 0,
    polish_steps: int = 4000,
    col_order: str = "weight",
):
    """PEG shift assignment on the committed support + joint ace6/ace8
    low-temperature anneal polish.  Returns (B, stats) with B guaranteed
    4-cycle-free (falls back to more polish if PEG alone leaves any —
    does not happen at the family-cell sizes, but Z
    smaller than the support density could force it)."""
    from tpu_ldpc_torch.codes.anneal import anneal_shifts

    Bp = peg_assign_shifts(B_committed, Z, seed=seed, col_order=col_order)
    B2, st = anneal_shifts(
        Bp, Z, steps=polish_steps, seed=seed + 7,
        w4=1e6, w6=1000.0, w8=1.0, ace=True, t0=0.1, t1=0.003,
    )
    if count_4cycles(B2, Z) != 0:  # pragma: no cover - safety net
        B2, st = anneal_shifts(
            B2, Z, steps=4 * polish_steps, seed=seed + 13,
            w4=1e6, w6=1000.0, w8=1.0, ace=True, t0=1.0, t1=0.003,
        )
    return B2, st
