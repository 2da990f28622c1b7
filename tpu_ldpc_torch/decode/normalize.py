"""Shift normalization (the port's copy of
``tpu_ldpc/decode/pallas_bp.py::_normalize_offsets``): per-block-row and
per-block-column coordinate rotations that zero as many circulant shifts
as they can.

Rotating the checks of block-row i by d_i and the variables of block-col
j by c_j turns edge (i, j, s) into an edge of *effective* shift
(s + d_i - c_j) mod Z.  The decoders then load the channel LLRs rotated
per column (position r of block-col j holds variable (r + c_j) mod Z),
run in those coordinates with the effective shifts, and un-rotate the hard
decisions on the way out: a pure relabeling, so bits, ok and iters_used
are those of the unrotated decoder.  An edge of effective shift 0 needs no
wrap arithmetic in a gather or a scatter.

On any Tanner cycle the alternating shift sum is invariant under the
rotations, so in general at most a spanning tree's worth of edges (mb +
nb - 1) can be zeroed.  The search is the JAX package's, kept identical
so both pick the same offsets: the identity start and 12 random
spanning-tree starts from ``np.random.default_rng(0)``, each improved by up
to 64 rounds of coordinate ascent (every node update is exact for its
incident edges, so the zero count never drops), ties broken to the
smallest value.  The identity start makes the result never worse than
the unrotated layout.
"""

from __future__ import annotations

import functools

import numpy as np


def normalize_offsets(lay):
    """(row_off, col_off): lists of mb and nb ints in [0, Z) for a
    TannerLayout."""
    Z, mb, nb = lay.Z, lay.mb, lay.nb
    er = np.asarray(lay.edge_row, dtype=np.int64)
    ec = np.asarray(lay.edge_col, dtype=np.int64)
    es = np.asarray(lay.edge_shift, dtype=np.int64)
    rows_of = [np.nonzero(er == i)[0] for i in range(mb)]
    cols_of = [np.nonzero(ec == j)[0] for j in range(nb)]

    def zeros(d, c):
        return int(np.sum((es + d[er] - c[ec]) % Z == 0))

    def ascend(d, c):
        for _ in range(64):
            changed = False
            for i in range(mb):
                edges = rows_of[i]
                if len(edges) == 0:
                    continue
                cand = (c[ec[edges]] - es[edges]) % Z
                vals, cnt = np.unique(cand, return_counts=True)
                best = set(vals[cnt == cnt.max()])
                if d[i] not in best:
                    d[i] = int(min(best))
                    changed = True
            for j in range(nb):
                edges = cols_of[j]
                if len(edges) == 0:
                    continue
                cand = (es[edges] + d[er[edges]]) % Z
                vals, cnt = np.unique(cand, return_counts=True)
                best = set(vals[cnt == cnt.max()])
                if c[j] not in best:
                    c[j] = int(min(best))
                    changed = True
            if not changed:
                break
        return d, c

    def tree_start(rng):
        d = np.zeros(mb, np.int64)
        c = np.zeros(nb, np.int64)
        seen_r = np.zeros(mb, bool)
        seen_c = np.zeros(nb, bool)
        # DFS over the bipartite base graph in a random edge order; tree
        # edges get effective shift 0 by construction
        adj_r = [rng.permutation(rows_of[i]) for i in range(mb)]
        adj_c = [rng.permutation(cols_of[j]) for j in range(nb)]
        for root in range(mb):
            if seen_r[root]:
                continue
            seen_r[root] = True
            stack = [("r", root)]
            while stack:
                kind, u = stack.pop()
                if kind == "r":
                    for e in adj_r[u]:
                        j = ec[e]
                        if not seen_c[j]:
                            seen_c[j] = True
                            c[j] = (d[u] + es[e]) % Z
                            stack.append(("c", j))
                else:
                    for e in adj_c[u]:
                        i = er[e]
                        if not seen_r[i]:
                            seen_r[i] = True
                            d[i] = (c[u] - es[e]) % Z
                            stack.append(("r", i))
        return d, c

    rng = np.random.default_rng(0)
    best_d, best_c = ascend(np.zeros(mb, np.int64), np.zeros(nb, np.int64))
    best_z = zeros(best_d, best_c)
    for _ in range(12):
        d, c = ascend(*tree_start(rng))
        z = zeros(d, c)
        if z > best_z:
            best_d, best_c, best_z = d, c, z
    return [int(x) % Z for x in best_d], [int(x) % Z for x in best_c]


@functools.lru_cache(maxsize=64)
def coordinates(code, normalize: bool):
    """(shifts, col_off): tuples of the E edges' shifts and the nb column
    offsets the decoders run with -- the effective shifts (s + d_i - c_j)
    mod Z and c_j of ``normalize_offsets``, or the layout's shifts and
    zeros."""
    lay = code.layout
    if not normalize:
        return tuple(int(s) for s in lay.edge_shift), (0,) * lay.nb
    row_off, col_off = normalize_offsets(lay)
    shifts = tuple(
        int(s + row_off[i] - col_off[j]) % lay.Z
        for i, j, s in zip(lay.edge_row, lay.edge_col, lay.edge_shift))
    return shifts, tuple(col_off)
