"""QC-LDPC base graphs: the registry, cycle analysis, girth-aware shift
selection and family-cell construction (the port's copy of
``tpu_ldpc/codes/base_graphs.py``).

The 24 wifi / wimax family cells are read from the port's copies of the
committed shift tables (``codes/data/*.qc``); a cell without a table is
generated (``generate_family_cell``: girth-aware shifts, then the
annealer of ``codes/anneal.py``, optionally on a PEXIT-optimized mask of
``codes/data/profiles.json``).  The public cycle counters run on the
native host helper (``tpu_ldpc_torch/_native``); the pure-Python
``_*_py`` versions are the plain versions the tests hold it against.

Base-matrix convention: B[i, j] == -1 means the (Z x Z) zero block;
B[i, j] == s in [0, Z) means the circulant P^s with P^s[r, c] = 1 iff
c == (r + s) % Z  (check r of block-row i touches variable (r+s)%Z of
block-col j).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# ---------------------------------------------------------------------------
# Cycle analysis on the protograph (standard QC girth conditions):
# a length-2L cycle in H exists iff an alternating base-graph cycle
# (i1,j1),(i1,j2),(i2,j2),...,(iL,j1) has alternating shift sum == 0 mod Z.
# ---------------------------------------------------------------------------


def _entries(B: np.ndarray):
    mb, nb = B.shape
    by_row = [[j for j in range(nb) if B[i, j] >= 0] for i in range(mb)]
    by_col = [[i for i in range(mb) if B[i, j] >= 0] for j in range(nb)]
    return by_row, by_col


def count_4cycles(B: np.ndarray, Z: int) -> int:
    """Number of (row-pair, col-pair) 4-cycle patterns with shift sum 0."""
    from tpu_ldpc_torch import _native

    return _native.count_4cycles(np.asarray(B), Z)


def _count_4cycles_py(B: np.ndarray, Z: int) -> int:
    mb, nb = B.shape
    count = 0
    for i1 in range(mb):
        for i2 in range(i1 + 1, mb):
            cols = np.nonzero((B[i1] >= 0) & (B[i2] >= 0))[0]
            for a in range(len(cols)):
                for b in range(a + 1, len(cols)):
                    j1, j2 = cols[a], cols[b]
                    d = (B[i1, j1] - B[i1, j2] + B[i2, j2] - B[i2, j1]) % Z
                    if d == 0:
                        count += 1
    return count


def count_6cycles(B: np.ndarray, Z: int) -> int:
    """Number of base-graph 6-cycle patterns with zero alternating shift sum."""
    from tpu_ldpc_torch import _native

    return _native.count_6cycles(np.asarray(B), Z)


def _count_6cycles_py(B: np.ndarray, Z: int) -> int:
    mb, nb = B.shape
    by_row, _ = _entries(B)
    # enumerate cycles as (i1,j1)-(i1,j2)-(i2,j2)-(i2,j3)-(i3,j3)-(i3,j1)
    # with i1 strictly the smallest row; each 6-cycle is then counted
    # exactly once per direction, so halve at the end.
    raw = 0
    for i1 in range(mb):
        for j1 in by_row[i1]:
            for j2 in by_row[i1]:
                if j2 == j1:
                    continue
                for i2 in range(mb):
                    if i2 <= i1 or B[i2, j2] < 0:
                        continue
                    for j3 in by_row[i2]:
                        if j3 == j1 or j3 == j2:
                            continue
                        for i3 in range(i1 + 1, mb):
                            if i3 == i2:
                                continue
                            if B[i3, j3] < 0 or B[i3, j1] < 0:
                                continue
                            s = (
                                B[i1, j1] - B[i1, j2]
                                + B[i2, j2] - B[i2, j3]
                                + B[i3, j3] - B[i3, j1]
                            ) % Z
                            if s == 0:
                                raw += 1
    return raw // 2


def ace6_cost(B: np.ndarray, Z: int) -> float:
    """ACE-weighted 6-cycle cost: cycles through low-degree variable
    nodes (low ACE) count ~1, cycles through high-degree nodes are
    nearly free (weight 2^-(sum col degrees - 6) per cycle)."""
    from tpu_ldpc_torch import _native

    return _native.ace6_cost(np.asarray(B), Z)


def _ace6_cost_py(B: np.ndarray, Z: int) -> float:
    mb, nb = B.shape
    by_row, _ = _entries(B)
    colw = (np.asarray(B) >= 0).sum(axis=0)
    raw = 0.0
    for i1 in range(mb):
        for j1 in by_row[i1]:
            for j2 in by_row[i1]:
                if j2 == j1:
                    continue
                for i2 in range(mb):
                    if i2 <= i1 or B[i2, j2] < 0:
                        continue
                    for j3 in by_row[i2]:
                        if j3 == j1 or j3 == j2:
                            continue
                        for i3 in range(i1 + 1, mb):
                            if i3 == i2:
                                continue
                            if B[i3, j3] < 0 or B[i3, j1] < 0:
                                continue
                            s = (
                                B[i1, j1] - B[i1, j2]
                                + B[i2, j2] - B[i2, j3]
                                + B[i3, j3] - B[i3, j1]
                            ) % Z
                            if s == 0:
                                ace = min(
                                    int(colw[j1] + colw[j2] + colw[j3]) - 6,
                                    40,
                                )
                                raw += 2.0 ** (-ace)
    return raw / 2.0


def _iter_8walks(B: np.ndarray, Z: int):
    """Yield (c1, c2, c3, c4) per accepted closed 8-walk tuple
    (non-backtracking, zero total alternating shift sum, and distinct
    lifted nodes at the base-node repeats length 8 allows; the number of
    lifted 8-cycles is Z * #tuples / 8)."""
    mb, nb = B.shape
    by_row, by_col = _entries(B)
    for r1 in range(mb):
        for c1 in by_row[r1]:
            for r2 in by_col[c1]:
                if r2 == r1:
                    continue
                p2 = (B[r1, c1] - B[r2, c1]) % Z
                for c2 in by_row[r2]:
                    if c2 == c1:
                        continue
                    p3 = (p2 + B[r2, c2]) % Z
                    for r3 in by_col[c2]:
                        if r3 == r2:
                            continue
                        p4 = (p3 - B[r3, c2]) % Z
                        if r3 == r1 and p4 == 0:
                            continue
                        for c3 in by_row[r3]:
                            if c3 == c2:
                                continue
                            p5 = (p4 + B[r3, c3]) % Z
                            if c3 == c1 and p5 == B[r1, c1] % Z:
                                continue
                            for r4 in by_col[c3]:
                                if r4 == r3 or r4 == r1:
                                    continue
                                p6 = (p5 - B[r4, c3]) % Z
                                if r4 == r2 and p6 == p2:
                                    continue
                                for c4 in by_row[r4]:
                                    if c4 == c3 or c4 == c1:
                                        continue
                                    if B[r1, c4] < 0:
                                        continue
                                    p7 = (p6 + B[r4, c4]) % Z
                                    if c4 == c2 and p7 == p3:
                                        continue
                                    if (p7 - B[r1, c4]) % Z != 0:
                                        continue
                                    yield (c1, c2, c3, c4)


def count_8cycles_raw(B: np.ndarray, Z: int) -> int:
    """Raw accepted-tuple count: #lifted 8-cycles == Z * raw / 8 exactly.
    Use for existence checks; count_8cycles divides by 8 for the
    per-base-pattern count."""
    from tpu_ldpc_torch import _native

    return _native.count_8cycles_raw(np.asarray(B), Z)


def _count_8cycles_raw_py(B: np.ndarray, Z: int) -> int:
    return sum(1 for _ in _iter_8walks(np.asarray(B), Z))


def count_8cycles(B: np.ndarray, Z: int) -> int:
    """Number of base-graph 8-cycle patterns (simple 8-cycles in the
    lifted Tanner graph per base pattern == lifted count / Z, like the
    4-/6-cycle counters; floors the half-pattern contributed by a
    doubly-wrapped 4-cycle, so use count_8cycles_raw for existence)."""
    return count_8cycles_raw(B, Z) // 8


def ace8_cost(B: np.ndarray, Z: int) -> float:
    """ACE-weighted 8-cycle cost (see ace6_cost): each 8-cycle weighs
    2^-(sum of its 4 visited column degrees - 8); a repeated base column
    is visited by two distinct lifted nodes and contributes twice."""
    from tpu_ldpc_torch import _native

    return _native.ace8_cost(np.asarray(B), Z)


def _ace8_cost_py(B: np.ndarray, Z: int) -> float:
    B = np.asarray(B)
    colw = (B >= 0).sum(axis=0)
    raw = 0.0
    for c1, c2, c3, c4 in _iter_8walks(B, Z):
        ace = min(int(colw[c1] + colw[c2] + colw[c3] + colw[c4]) - 8, 40)
        raw += 2.0 ** (-ace)
    return raw / 8.0


def girth_lower_bound(B: np.ndarray, Z: int) -> int:
    """Girth from 4-/6-/8-cycle checks: 4, 6, 8, or 10 ('at least 10')."""
    if count_4cycles(B, Z) > 0:
        return 4
    if count_6cycles(B, Z) > 0:
        return 6
    if count_8cycles_raw(B, Z) > 0:
        return 8
    return 10


# ---------------------------------------------------------------------------
# Greedy girth-aware shift selection
# ---------------------------------------------------------------------------


def _creates_4cycle(B, Z, i, j, s) -> bool:
    mb, nb = B.shape
    for i2 in range(mb):
        if i2 == i or B[i2, j] < 0:
            continue
        for j2 in range(nb):
            if j2 == j or B[i, j2] < 0 or B[i2, j2] < 0:
                continue
            if (s - B[i, j2] + B[i2, j2] - B[i2, j]) % Z == 0:
                return True
    return False


def _count_new_6cycles(B, Z, by_row, by_col, i, j, s) -> int:
    """6-cycles through a prospective entry (i, j, s) w.r.t. existing entries."""
    count = 0
    for j2 in by_row[i]:
        if j2 == j:
            continue
        for i3 in by_col[j]:
            if i3 == i:
                continue
            for i2 in by_col[j2]:
                if i2 == i or i2 == i3:
                    continue
                for j3 in by_row[i2]:
                    if j3 == j or j3 == j2 or B[i3, j3] < 0:
                        continue
                    d = (
                        s - B[i, j2]
                        + B[i2, j2] - B[i2, j3]
                        + B[i3, j3] - B[i3, j]
                    ) % Z
                    if d == 0:
                        count += 1
    return count


def select_shifts(
    B_mask: np.ndarray,
    Z: int,
    seed: int,
    fixed: dict[tuple[int, int], int] | None = None,
    candidates_per_entry: int = 16,
) -> np.ndarray:
    """Assign circulant shifts to a base-graph mask, greedily avoiding
    4-cycles and minimizing 6-cycles (deterministic, seeded).

    Args:
      B_mask: (mb, nb) bool/int mask of nonzero blocks.
      fixed: entries with prescribed shifts (parity structure).
    Returns:
      B: (mb, nb) int array, -1 for zero blocks.
    """
    rng = np.random.default_rng(seed)
    mb, nb = B_mask.shape
    B = np.full((mb, nb), -1, dtype=np.int64)
    fixed = fixed or {}
    for (i, j), s in fixed.items():
        B[i, j] = s % Z
    # fill remaining entries column by column (info columns first)
    todo = [
        (i, j)
        for j in range(nb)
        for i in range(mb)
        if B_mask[i, j] and (i, j) not in fixed
    ]
    by_row, by_col = _entries(B)
    for (i, j) in todo:
        cand = rng.permutation(Z)[:candidates_per_entry]
        best, best_c6 = None, None
        fallback = None
        for s in cand:
            s = int(s)
            if _creates_4cycle(B, Z, i, j, s):
                # remember least-bad in case nothing is 4-cycle-free
                if fallback is None:
                    fallback = s
                continue
            c6 = _count_new_6cycles(B, Z, by_row, by_col, i, j, s)
            if c6 == 0:
                best = s
                break
            if best_c6 is None or c6 < best_c6:
                best, best_c6 = s, c6
        if best is None:
            # every candidate makes a 4-cycle; scan the whole ring
            for s in range(Z):
                if not _creates_4cycle(B, Z, i, j, s):
                    best = s
                    break
            if best is None:
                best = fallback if fallback is not None else 0
        B[i, j] = best
        by_row[i].append(j)
        by_col[j].append(i)
    return B


# ---------------------------------------------------------------------------
# Family construction (802.11n-style structure, generated shifts)
# ---------------------------------------------------------------------------


def make_base_graph(
    mb: int,
    nb: int,
    Z: int,
    seed: int = 0,
    n_heavy: int | None = None,
    info_weight: int | None = None,
) -> np.ndarray:
    """Build an 802.11n-style base matrix:

      B = [ A | h | D ]

    A: kb = nb - mb info columns — irregular: `n_heavy` full-weight
       columns, the rest weight 3 (weight 2 if mb < 4), shifts selected
       girth-aware.
    h: weight-3 closing parity column, shifts (1, 0, 1) at rows
       (0, mb//2, mb-1) — makes p0 recoverable by summing all block rows.
    D: (mb x mb-1) dual diagonal of 0-shifts (rows i-1, i for col i).
    """
    kb = nb - mb
    if kb <= 0:
        raise ValueError("nb must exceed mb")
    if n_heavy is None:
        n_heavy = max(1, kb // 4) if mb >= 6 else min(2, kb)
    mask = np.zeros((mb, nb), dtype=bool)
    fixed: dict[tuple[int, int], int] = {}
    rng = np.random.default_rng(seed + 0xC0DE)

    # info columns
    if info_weight is None:
        info_weight = 3 if mb >= 4 else 2
    base_w = info_weight
    heavy_cols = np.linspace(0, kb - 1, n_heavy).astype(int) if n_heavy else []
    for j in range(kb):
        if j in heavy_cols:
            mask[:, j] = True
        else:
            # spread weight-`base_w` columns across rows round-robin with jitter
            start = (j * base_w + int(rng.integers(mb))) % mb
            step = max(1, mb // base_w)
            rows = {(start + t * step) % mb for t in range(base_w)}
            while len(rows) < base_w:
                rows.add(int(rng.integers(mb)))
            for i in rows:
                mask[i, j] = True

    # weight-3 closing column h at col kb
    h_rows = (0, mb // 2, mb - 1)
    for r, s in zip(h_rows, (1, 0, 1)):
        mask[r, kb] = True
        fixed[(r, kb)] = s
    # dual diagonal
    for t in range(1, mb):
        col = kb + t
        mask[t - 1, col] = True
        mask[t, col] = True
        fixed[(t - 1, col)] = 0
        fixed[(t, col)] = 0

    return select_shifts(mask, Z, seed=seed, fixed=fixed)


def build_from_mask(mask: np.ndarray, Z: int, seed: int = 0) -> np.ndarray:
    """Assign girth-aware shifts to an externally optimized mask (e.g.
    from codes.pexit.search_mask).  The mask's parity part must carry the
    canonical structure (weight-3 closing column + dual diagonal); its
    shifts are pinned to the encodable pattern, everything else is
    selected greedily 4-cycle-free.
    """
    from tpu_ldpc_torch.codes.pexit import parity_mask

    mask = np.asarray(mask, dtype=bool)
    mb, nb = mask.shape
    kb = nb - mb
    pm, _ = parity_mask(mb, nb)
    if not np.array_equal(mask[:, kb:], pm[:, kb:]):
        raise ValueError("mask parity part is not the canonical structure")
    fixed: dict[tuple[int, int], int] = {}
    for r, s in zip((0, mb // 2, mb - 1), (1, 0, 1)):
        fixed[(r, kb)] = s
    for t in range(1, mb):
        fixed[(t - 1, kb + t)] = 0
        fixed[(t, kb + t)] = 0
    return select_shifts(mask, Z, seed=seed, fixed=fixed)


# rate name -> (mb, nb) protograph shape, 802.11n-style nb=24 templates
_RATE_SHAPES = {
    "1/2": (12, 24),
    "2/3": (8, 24),
    "3/4": (6, 24),
    "5/6": (4, 24),
}

# lift sizes exposed per family (wifi-style: n in {648, 1296, 1944};
# wimax-style: n in {576..2304})
FAMILY_LIFTS = {
    "wifi": (27, 54, 81),
    "wimax": (24, 48, 96),
}


def make_sc_base_graph(
    L: int, Z: int, seed: int = 0, coupling_width: int = 2
) -> np.ndarray:
    """Spatially-coupled (convolutional) LDPC protograph.

    Edge-spreading of a (3,6)-regular ensemble over L positions with
    memory `coupling_width`: position t contributes 2 block-columns
    whose weight-3 support sits in block-rows {t, t+1, t+2} — a banded
    base matrix.  mb = L + w rows, nb = 2L cols, design rate -> 1/2 as L
    grows (termination loss at the ends).  Shifts are chosen greedily
    4-cycle-free (select_shifts).
    """
    w = coupling_width
    if w != 2:
        raise NotImplementedError("edge spreading implemented for w=2")
    mb, nb = L + w, 2 * L
    mask = np.zeros((mb, nb), dtype=bool)
    for t in range(L):
        for dj in (0, 1):
            for k in range(w + 1):
                mask[t + k, 2 * t + dj] = True
    return select_shifts(mask, Z, seed=seed)


def family_cell_seed(family: str, rate: str, Z: int) -> int:
    """Deterministic construction seed for a (family, rate, Z) cell."""
    return (
        sum(ord(c) * 131 ** p for p, c in enumerate(family + "/" + rate))
        + 7919 * Z
    ) & 0x7FFFFFFF


@functools.lru_cache(maxsize=None)
def family_base_graph(family: str, rate: str, Z: int) -> np.ndarray:
    """The base graph of a (family, rate, Z) registry cell: its committed
    shift table, else the cell generated from its seed."""
    if family not in FAMILY_LIFTS:
        raise ValueError(f"unknown family {family!r}; have {list(FAMILY_LIFTS)}")
    if rate not in _RATE_SHAPES:
        raise ValueError(f"unknown rate {rate!r}; have {list(_RATE_SHAPES)}")
    if Z not in FAMILY_LIFTS[family]:
        raise ValueError(
            f"family {family!r} supports Z in {FAMILY_LIFTS[family]}, got {Z}"
        )
    path = os.path.join(_DATA_DIR, f"{family}_r{rate.replace('/', '')}_z{Z}.qc")
    if os.path.exists(path):
        from tpu_ldpc_torch.codes.alist import load_shift_table

        return np.asarray(load_shift_table(path).B)
    return generate_family_cell(family, rate, Z,
                                family_cell_seed(family, rate, Z))


@functools.lru_cache(maxsize=None)
def _load_profiles() -> dict:
    """PEXIT-optimized degree profiles (codes/pexit.py search output):
    per rate, masks ranked by ensemble BP threshold."""
    import json

    path = os.path.join(_DATA_DIR, "profiles.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def generate_family_cell(
    family: str, rate: str, Z: int, seed: int, profile: str = "legacy"
) -> np.ndarray:
    """Construct + girth-anneal one family cell (what produced the
    committed data tables; kept for reproducibility and custom cells).

    profile:
      'legacy' (default) -- heavy columns + weight-4 info columns, the
        profile that measured best at the registry's blocklengths
        (n ~ 1-2.3k) in the JAX package's CPU FER runs.
      'pexit' -- degree profile from the committed PEXIT mask registry
        (codes/pexit.py search output, data/profiles.json), masks tried
        in threshold rank order subject to 4-cycle-free liftability.
        Better asymptotically; use for large Z / long blocklengths.
    """
    from tpu_ldpc_torch.codes.anneal import anneal_shifts

    mb, nb = _RATE_SHAPES[rate]
    if profile == "pexit":
        prof = _load_profiles().get(rate)
        masks = list(prof["masks"]) if prof else []
        if family != "wifi" and len(masks) > 1:
            # keep families distinct: non-wifi prefers the runner-up mask
            masks = masks[1:] + masks[:1]
        for mask in masks:
            B = build_from_mask(np.asarray(mask, bool), Z, seed=seed)
            B, stats = anneal_shifts(B, Z, steps=15000, seed=seed,
                                     w4=1e6, ace=True)
            if stats["c4"] == 0:
                return B
        # no registry / nothing liftable: fall through to legacy
    B = make_base_graph(mb, nb, Z, seed=seed,
                        info_weight=4 if mb >= 6 else 3)
    B, _stats = anneal_shifts(B, Z, steps=2000, seed=seed)
    return B


@functools.lru_cache(maxsize=None)
def judged_base_graph() -> np.ndarray:
    """The judged (1024, 512) rate-1/2 code: 8x16 base, Z=64."""
    return make_base_graph(8, 16, 64, seed=20260817)
