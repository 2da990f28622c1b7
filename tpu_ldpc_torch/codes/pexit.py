"""Protograph EXIT (PEXIT) analysis and threshold-driven mask search (the
port's copy of ``tpu_ldpc/codes/pexit.py``).

The reference library's construction quality comes from optimizing the
code ensemble, not just the circulant shifts.  This module supplies the
ensemble-level half of that capability for the generated families: a
Gaussian-approximation protograph EXIT chart (Liva & Chiani 2007 PEXIT
formulation, ten Brink J-function) that predicts the BP decoding
threshold of a base-graph *mask*, and a simulated-annealing search over
masks that minimizes that threshold subject to the structural
constraints our encoder and kernels rely on (dual-diagonal parity part
frozen, bounded column/row weights).

Pipeline: search_mask() picks the degree profile + placement →
base_graphs.select_shifts()/anneal.anneal_shifts() pick circulant
shifts for girth — ensemble quality and cycle quality are optimized at
the right levels.

Pure host-side NumPy; never on the device path.

J-function closed form (Brannstrom/ten Brink curve fit): exact mutual
inverses, adequate for threshold search (|error| < 0.01 bit everywhere,
~0.02 dB threshold bias — constant across candidates, so ranking is
unaffected).
"""

from __future__ import annotations

import numpy as np

_H1, _H2, _H3 = 0.3073, 0.8935, 1.1064
_EPS = 1e-12


def J(sigma):
    """Mutual information of a consistent Gaussian LLR with std `sigma`."""
    sigma = np.maximum(sigma, 0.0)
    return (1.0 - 2.0 ** (-_H1 * sigma ** (2.0 * _H2))) ** _H3


def J_inv(I):
    """Inverse of J (exact inverse of the closed form above)."""
    I = np.clip(I, _EPS, 1.0 - _EPS)
    return ((-1.0 / _H1) * np.log2(1.0 - I ** (1.0 / _H3))) ** (1.0 / (2.0 * _H2))


def pexit_converges(
    mask: np.ndarray,
    ebn0_db,
    rate: float | None = None,
    max_iters: int = 400,
    target: float = 0.9999,
    stall_tol: float = 1e-8,
):
    """Vectorized PEXIT recursion: does BP converge at each Eb/N0 point?

    Args:
      mask: (mb, nb) 0/1 protograph adjacency (multiplicity 1 blocks).
      ebn0_db: scalar or (S,) grid of Eb/N0 values in dB.
      rate: code rate; default (nb - mb) / nb.
    Returns:
      bool array shaped like ebn0_db: True where the a-posteriori MI of
      every variable node exceeds `target` within max_iters.
    """
    mask = np.asarray(mask, dtype=bool)
    mb, nb = mask.shape
    if rate is None:
        rate = (nb - mb) / nb
    eb = np.atleast_1d(np.asarray(ebn0_db, dtype=np.float64))
    S = eb.shape[0]
    # BPSK-AWGN channel LLR ~ N(sigma^2/2, sigma^2), sigma^2 = 8 R Eb/N0
    sig2_ch = 8.0 * rate * 10.0 ** (eb / 10.0)  # (S,)
    sig2_ch = sig2_ch[:, None, None]
    m = mask[None, :, :]

    I_cv = np.zeros((S, mb, nb))
    done = np.zeros(S, dtype=bool)
    for _ in range(max_iters):
        prev = I_cv
        # VN -> CN: combine channel + extrinsic CN inputs from other rows
        V = np.where(m, J_inv(I_cv) ** 2, 0.0)
        colsum = V.sum(axis=1, keepdims=True)
        I_vc = J(np.sqrt(np.maximum(colsum - V + sig2_ch, 0.0)))
        # CN -> VN: duality via 1 - I
        W = np.where(m, J_inv(1.0 - I_vc) ** 2, 0.0)
        rowsum = W.sum(axis=2, keepdims=True)
        I_cv = np.where(m, 1.0 - J(np.sqrt(np.maximum(rowsum - W, 0.0))), 0.0)
        # a-posteriori MI per VN
        Vp = np.where(m, J_inv(I_cv) ** 2, 0.0)
        I_app = J(np.sqrt(Vp.sum(axis=1) + sig2_ch[:, :, 0]))
        done |= (I_app > target).all(axis=1)
        # below-threshold points reach a sub-unity fixed point: once every
        # non-converged point has stalled, further iterations are no-ops
        delta = np.abs(I_cv - prev).max(axis=(1, 2))
        if (done | (delta < stall_tol)).all():
            break
    return done if np.ndim(ebn0_db) else bool(done[0])


def pexit_threshold(
    mask: np.ndarray,
    rate: float | None = None,
    lo: float = -0.5,
    hi: float = 4.0,
    step: float = 0.05,
    max_iters: int = 400,
    stall_tol: float = 1e-8,
) -> float:
    """BP threshold estimate: lowest grid point where PEXIT converges.

    One vectorized run over the whole grid; returns `hi` + step if no
    point converges (so worse-is-larger holds for search costs).
    """
    grid = np.arange(lo, hi + step / 2, step)
    ok = pexit_converges(mask, grid, rate=rate, max_iters=max_iters,
                         stall_tol=stall_tol)
    idx = np.nonzero(ok)[0]
    return float(grid[idx[0]]) if idx.size else float(hi + step)


# ---------------------------------------------------------------------------
# Threshold-driven mask search
# ---------------------------------------------------------------------------


def parity_mask(mb: int, nb: int) -> tuple[np.ndarray, np.ndarray]:
    """The frozen 802.11n-style parity structure: weight-3 closing column
    + dual diagonal (mirrors base_graphs.make_base_graph)."""
    kb = nb - mb
    mask = np.zeros((mb, nb), dtype=bool)
    frozen = np.zeros((mb, nb), dtype=bool)
    for r in (0, mb // 2, mb - 1):
        mask[r, kb] = True
    for t in range(1, mb):
        mask[t - 1, kb + t] = True
        mask[t, kb + t] = True
    frozen[:, kb:] = True
    return mask, frozen


def search_mask(
    mb: int,
    nb: int,
    seed: int = 0,
    steps: int = 1200,
    col_w_min: int = 3,
    col_w_max: int | None = None,
    row_w_max: int | None = None,
    t0: float = 0.15,
    t1: float = 0.005,
    threshold_kwargs: dict | None = None,
    init_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, dict]:
    """Anneal the info-part mask to minimize the PEXIT threshold.

    Moves: relocate one info entry to another row / add an entry /
    remove an entry, respecting column-weight in [col_w_min, col_w_max]
    and row-weight <= row_w_max (kernel edge-count discipline).  The
    parity part is frozen so dual-diagonal encodability is preserved.

    Returns (mask, stats).  Deterministic in `seed`.
    """
    kb = nb - mb
    if kb <= 0:
        raise ValueError("nb must exceed mb")
    col_w_max = col_w_max or mb
    row_w_max = row_w_max or max(8, int(np.ceil(4.5 * nb / mb)))
    tkw = dict(threshold_kwargs or {})
    rng = np.random.default_rng(seed)

    mask, _frozen = parity_mask(mb, nb)
    if init_mask is not None:
        init_mask = np.asarray(init_mask, dtype=bool)
        if init_mask.shape != (mb, nb):
            raise ValueError("init_mask shape mismatch")
        mask[:, :kb] = init_mask[:, :kb]  # parity part stays canonical
    else:
        # init: weight-3 info columns, rows round-robin
        for j in range(kb):
            for t in range(3):
                mask[(j + t * max(1, mb // 3)) % mb, j] = True
            while mask[:, j].sum() < min(col_w_min, mb):
                mask[int(rng.integers(mb)), j] = True

    def cost(mk):
        return pexit_threshold(mk, **tkw)

    cur = cost(mask)
    best_mask, best = mask.copy(), cur
    accepted = evals = 0
    for s in range(steps):
        temp = t0 * (t1 / t0) ** (s / max(steps - 1, 1))
        j = int(rng.integers(kb))
        rows_on = np.nonzero(mask[:, j])[0]
        rows_off = np.nonzero(~mask[:, j])[0]
        w = len(rows_on)
        mv = rng.random()
        trial = mask.copy()
        if mv < 0.6 and len(rows_off):
            # relocate
            trial[rows_on[rng.integers(w)], j] = False
            trial[rows_off[rng.integers(len(rows_off))], j] = True
        elif mv < 0.8 and w < col_w_max and len(rows_off):
            trial[rows_off[rng.integers(len(rows_off))], j] = True
        elif w > col_w_min:
            trial[rows_on[rng.integers(w)], j] = False
        else:
            continue
        if (trial.sum(axis=1) > row_w_max).any():
            continue
        if (trial.sum(axis=1) < 2).any():
            continue
        c = cost(trial)
        evals += 1
        if c <= cur or rng.random() < np.exp((cur - c) / temp):
            mask, cur = trial, c
            accepted += 1
            if c < best:
                best_mask, best = trial.copy(), c
    return best_mask, {
        "threshold_db": best,
        "steps": steps,
        "evals": evals,
        "accepted": accepted,
        "edges": int(best_mask.sum()),
        "col_weights": best_mask.sum(axis=0).tolist(),
        "row_weights": best_mask.sum(axis=1).tolist(),
    }
