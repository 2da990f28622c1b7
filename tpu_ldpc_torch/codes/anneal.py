"""Simulated-annealing circulant-shift optimization (the port's copy of
``tpu_ldpc/codes/anneal.py``).

Refine a QC base matrix's shifts to maximize girth / minimize short-cycle
counts:
plain simulated annealing on the cost  w4 * #4-cycles + w6 * #6-cycles,
proposing single-entry shift changes on the information part (the
dual-diagonal parity structure is frozen so encodability is preserved).

Pure host-side construction tooling, never on the device path.  The
same seed draws the same ``default_rng`` sequence as the JAX package's
annealer, and the costs are the same doubles (the native helper sums
the ACE weights, powers of two, in the JAX helper's order), so the same
inputs give the same table.
"""

from __future__ import annotations

import numpy as np

from tpu_ldpc_torch.codes.base_graphs import (
    ace6_cost,
    ace8_cost,
    count_4cycles,
    count_6cycles,
    count_8cycles,
)


def _cost(B, Z, w4, w6, w8, ace=False):
    c6 = ace6_cost(B, Z) if ace else count_6cycles(B, Z)
    cost = w4 * count_4cycles(B, Z) + w6 * c6
    if w8:
        cost += w8 * (ace8_cost(B, Z) if ace else count_8cycles(B, Z))
    return cost


def anneal_shifts(
    B: np.ndarray,
    Z: int,
    steps: int = 2000,
    seed: int = 0,
    w4: float = 1000.0,
    w6: float = 1.0,
    w8: float = 0.0,
    t0: float = 5.0,
    t1: float = 0.01,
    frozen_cols: list[int] | None = None,
    ace: bool = False,
):
    """Refine shifts by simulated annealing.

    Args:
      frozen_cols: columns whose entries must not change; defaults to the
        parity part (the last mb columns).
      ace: weight 6-/8-cycles by 2^-ACE (cycles through low-degree
        columns dominate) instead of counting them uniformly.
      w8: weight on the 8-cycle term (with only 4-/6-cycle counters the
        anneal cannot see past girth 8 or rank girth-8 candidates).  Keep
        w8 << w6: trading a 6-cycle for many 8-cycles is almost always a
        win.
    Returns:
      (B_optimized, stats dict)
    """
    B = np.asarray(B).copy()
    mb, nb = B.shape
    if frozen_cols is None:
        frozen_cols = list(range(nb - mb, nb))
    frozen = set(frozen_cols)
    sites = [
        (i, j)
        for i in range(mb)
        for j in range(nb)
        if B[i, j] >= 0 and j not in frozen
    ]
    if not sites:
        return B, {
            "steps": 0,
            "cost": _cost(B, Z, w4, w6, w8, ace),
            "c4": count_4cycles(B, Z),
            "c6": count_6cycles(B, Z),
            "c8": count_8cycles(B, Z),
        }
    rng = np.random.default_rng(seed)
    cost = _cost(B, Z, w4, w6, w8, ace)
    best, best_cost = B.copy(), cost
    accepted = 0
    for step in range(steps):
        temp = t0 * (t1 / t0) ** (step / max(steps - 1, 1))
        i, j = sites[rng.integers(len(sites))]
        old = B[i, j]
        new = int(rng.integers(Z))
        if new == old:
            continue
        B[i, j] = new
        c = _cost(B, Z, w4, w6, w8, ace)
        if c <= cost or rng.random() < np.exp((cost - c) / temp):
            cost = c
            accepted += 1
            if c < best_cost:
                best, best_cost = B.copy(), c
        else:
            B[i, j] = old
        if best_cost == 0:
            break
    return best, {
        "steps": steps,
        "accepted": accepted,
        "cost": float(best_cost),
        "c4": count_4cycles(best, Z),
        "c6": count_6cycles(best, Z),
        "c8": count_8cycles(best, Z),
    }
