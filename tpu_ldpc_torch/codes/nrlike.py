"""5G-NR-style rate-compatible base-graph family (port of
``tpu_ldpc/codes/nrlike.py``; NumPy, the same tables as the JAX
package's).

A structural emulation of the NR LDPC design, not a copied 3GPP table:
every shift comes from the seeded girth-aware search of
``base_graphs.select_shifts``.

  * kb = 22 systematic block-columns ("BG1-like"); the first two are
    high-degree and always punctured at transmission: their LLRs enter
    the decoder as erasures and are recovered through their many parity
    observations.  The mother code is a lower-rate code than what is on
    air.
  * A 4-row core: weight-3 closing parity column + dual diagonal.
  * Extension rows 4..m-1, each with a degree-1 parity column (the
    raptor-like incremental-redundancy structure): appending rows only
    adds parity observations, so one mother graph serves every rate by
    row/column truncation (B[:m, :kb+m]), which is what IR-HARQ
    (``sim/harq.py``) needs.
  * Nested by construction: shifts are selected once on the mother
    graph, so a 4-cycle-free mother stays 4-cycle-free at every rate.

Transmitted rate at m rows: kb / (kb + m - 2) (2 punctured blocks).
The extension rows break the dual-diagonal form, so ``select_encoder``
encodes these codes with the generator path.  ``nrlike_adapt(code)`` is
the standard first-two-blocks puncturing spec (``channel/adapt.py``).
"""

from __future__ import annotations

import functools

import numpy as np

from tpu_ldpc_torch.codes import base_graphs

KB = 22          # BG1-like systematic block-columns
M_MOTHER = 24    # BG1 mother graph rows: rate 22/44 = 1/2 on air
# nominal rate -> extension depth m (true tx rate = kb/(kb+m-2))
M_BY_RATE = {"1/2": 24, "2/3": 13, "3/4": 10, "5/6": 7}

# "BG2-like": kb=10, short blocks, LOW rates — the registry's only
# coverage below rate 1/2.  Mother at m=42 is rate 10/50 = 1/5 on air.
KB2 = 10
M_MOTHER2 = 42
M_BY_RATE2 = {"1/5": 42, "2/7": 27, "2/5": 17, "1/2": 12, "2/3": 7}


def _mother_mask(kb: int, m: int, seed: int):
    """(m, kb+m) bool mask + pinned parity shifts for the NR-like
    skeleton described in the module docstring.

    Two regimes, measured when the family was designed (the JAX
    package's notes; CPU A/B, 2026-08-21):
    - kb=22 ("BG1", m<=24): dense punctured-column coverage (every
      extension row) and uniform degree-3 extension info — measured
      excellent at rates 1/2..5/6.
    - kb=10 ("BG2", m<=42, rates to 1/5): that dense/uniform recipe
      COLLAPSES under min-sum at low rate (rate-1/5 FER 1.0 at 2.0 dB
      while exact SP still decodes!).  Two structural fixes, each
      measured necessary: punctured columns touch only every OTHER
      extension row (degree ~14, not ~29 — heavy zero-LLR columns
      poison min-sum's magnitude propagation), and extension info
      degree TAPERS 3 -> 2 from row 16 (at rate 1/5 the per-symbol
      SNR is ~-5 dB; deep checks must be small to extract anything —
      an IRA-style parity accumulator measured even worse).  Result:
      rate-1/5 FER 0.70 -> 0.000 at 1.5 dB, 6e-3 at 1.1 dB.
    """
    nb = kb + m
    mask = np.zeros((m, nb), dtype=bool)
    fixed: dict[tuple[int, int], int] = {}
    rng = np.random.default_rng(seed + 0x5697)
    deep = kb == KB2  # BG2-like low-rate regime

    # two high-degree punctured info columns: all core rows + round-
    # robin extension coverage (dense for BG1, every-other-row for BG2)
    for j in (0, 1):
        mask[:4, j] = True
    for i in range(4, m):
        if deep:
            if i % 2 == 0:
                mask[i, (i // 2) % 2] = True
        else:
            mask[i, i % 2] = True
            if i % 3 == 0:
                mask[i, 1 - i % 2] = True

    # regular info columns: degree 3 in the core (each col skips one
    # core row, round-robin).  This mirrors the real NR BG1, whose
    # first rows contain nearly every info column — and it is MEASURED
    # essential here: with degree-2 core columns the high-rate
    # truncations collapsed (r23 FER 0.25 @ 2.6 dB vs 2e-3 with
    # degree 3; r12 19/3072 vs 0/3072 @ 2.0 dB, CPU A/B 2026-08-21)
    for j in range(2, kb):
        drop = (j - 2) % 4
        for r in range(4):
            if r != drop:
                mask[r, j] = True
    # extension rows: regular info columns round-robin with seeded
    # jitter so every truncation prefix keeps column degrees balanced;
    # BG2 tapers the degree 3 -> 2 from row 16 (see docstring)
    for i in range(4, m):
        d = 2 if (deep and i >= 16) else 3
        start = (3 * (i - 4) + int(rng.integers(3))) % (kb - 2)
        step = max(1, (kb - 2) // d)
        for t in range(d):
            mask[i, 2 + (start + t * step) % (kb - 2)] = True
        # every other extension row also observes one core parity
        # (shallow rows only in the BG2 regime)
        if i % 2 == 0 and not (deep and i >= 16):
            mask[i, kb + 1 + (i // 2) % 3] = True

    # core parity (cols kb..kb+3): weight-3 closing column + 4-row
    # dual diagonal, the repo's canonical encodable pattern
    for r, s in zip((0, 2, 3), (1, 0, 1)):
        mask[r, kb] = True
        fixed[(r, kb)] = s
    for t in range(1, 4):
        col = kb + t
        mask[t - 1, col] = True
        mask[t, col] = True
        fixed[(t - 1, col)] = 0
        fixed[(t, col)] = 0
    # extension parity: degree-1 identity blocks
    for i in range(4, m):
        mask[i, kb + i] = True
        fixed[(i, kb + i)] = 0
    return mask, fixed


@functools.lru_cache(maxsize=16)
def make_nrlike_base_graph(Z: int, m: int = M_MOTHER, kb: int = KB,
                           seed: int = 11) -> np.ndarray:
    """(m, kb+m) shift table for the NR-like cell, truncated from the
    full mother (M_MOTHER rows for kb=22, M_MOTHER2 for kb=10) so all
    rate points are nested."""
    m_mother = M_MOTHER2 if kb == KB2 else M_MOTHER
    if not 4 <= m <= m_mother:
        raise ValueError(f"m must be in [4, {m_mother}], got {m}")
    mask, fixed = _mother_mask(kb, m_mother, seed)
    B = base_graphs.select_shifts(mask, Z, seed=seed, fixed=fixed)
    return B[:m, : kb + m]


def nrlike_code(rate: str, Z: int, seed: int = 11, bg: int = 1):
    """Registry cell nr{bg}_r{rate}_z{Z}: the truncated NR-like code
    at the nominal rate point (true tx rate = kb/(kb+m-2) with the
    first two blocks punctured — see nrlike_adapt).

    bg=1: kb=22, rates 1/2..5/6 (M_BY_RATE).
    bg=2: kb=10, rates 1/5..2/3 (M_BY_RATE2) — short blocks, the low-
    rate regime; same skeleton, deeper extension (mother rate 1/5)."""
    from tpu_ldpc_torch.codes.code import LdpcCode

    table = M_BY_RATE if bg == 1 else M_BY_RATE2
    kb = KB if bg == 1 else KB2
    if rate not in table:
        raise ValueError(f"bg{bg} rate must be one of {sorted(table)}")
    m = table[rate]
    B = make_nrlike_base_graph(Z, m=m, kb=kb, seed=seed)
    return LdpcCode(f"nr{bg}_r{rate.replace('/', '')}_z{Z}", B, Z)


def nrlike_adapt(code):
    """The family's standard transmission spec: puncture the two
    high-degree systematic block-columns (never on air)."""
    from tpu_ldpc_torch.channel.adapt import RateAdapt

    return RateAdapt.from_blocks(code, puncture_blocks=(0, 1))


def tx_rate(code) -> float:
    """True transmitted rate k / (n - 2Z) under nrlike_adapt."""
    return nrlike_adapt(code).rate(code.n, code.k)
