"""Per-cell two-phase knob resolution (port of ``tpu_ldpc/decode/knobs.py``).

The two-phase ET decoder's (phase1_iters K, compact budget B) are
operating-point parameters: a budget that is too small sends most
batches through the full-batch fallback.

Resolution order for a knob the caller left unset:
  1. the knob table ``codes/data/twophase_knobs.json`` (the port's copy
     of the JAX package's table), per (cell name, schedule);
  2. rate-derived defaults: K from the cell's code rate (higher rate
     converges faster at its operating point, so a smaller K), budget
     512 (1280 below rate 0.35).

The table's (K, budget) values were tuned for throughput on a TPU, where
an early-terminated tile exits only when all of its 128 lanes converge.
They are NOT tuned for the H100, where each codeword's block exits on
its own: re-derive them there with ``decode.twophase.tune_phase1_iters``
and a timed comparison.  Explicit caller knobs always win.
"""

from __future__ import annotations

import functools
import json
import os

_KNOBS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "codes", "data", "twophase_knobs.json")


@functools.lru_cache(maxsize=1)
def _load_table() -> dict:
    """{cell name: {schedule: {K, budget, iters, ebn0_db, source}}}; the
    values were measured on a TPU (see the module docstring)."""
    with open(_KNOBS_PATH) as f:
        return json.load(f).get("cells", {})


def registry_entry(code, schedule: str) -> dict | None:
    """The table entry for (cell, schedule), or None.  Besides (K,
    budget) it records the operating context the knobs were chosen in:
    `iters` (total iteration budget) and `ebn0_db`."""
    return _load_table().get(getattr(code, "name", ""), {}).get(schedule)


def _derived_k(rate: float, schedule: str) -> int:
    """Rate-derived phase-1 budget for cells without table knobs; flooding
    converges about half as fast per iteration as layered, so its K is
    about twice the layered value."""
    if rate < 0.35:
        k = 14
    elif rate < 0.58:
        k = 9
    elif rate < 0.79:
        k = 8
    else:
        k = 7
    return k if schedule == "layered" else 2 * k - 2


def _derived_budget(rate: float) -> int:
    """Derived compaction budget: 512, or 1280 for low-rate cells, whose
    stragglers past K are many more."""
    return 1280 if rate < 0.35 else 512


def resolve_twophase_knobs(code, schedule: str,
                           phase1_iters: int | None,
                           compact_budget: int | None):
    """Fill in unset two-phase knobs for this code cell.

    code: LdpcCode (its .name keys the table, its .rate feeds the
      derived fallback).
    Returns (phase1_iters, compact_budget, source) where source is
    'explicit', 'registry', or 'derived' -- the loosest origin among the
    two knobs (explicit < registry < derived).
    """
    if phase1_iters is not None and compact_budget is not None:
        return int(phase1_iters), int(compact_budget), "explicit"
    entry = registry_entry(code, schedule)
    if entry is not None:
        k = phase1_iters if phase1_iters is not None else entry["K"]
        b = compact_budget if compact_budget is not None else entry["budget"]
        return int(k), int(b), "registry"
    rate = float(getattr(code, "rate", 0.5))
    k = (phase1_iters if phase1_iters is not None
         else _derived_k(rate, schedule))
    b = (compact_budget if compact_budget is not None
         else _derived_budget(rate))
    return int(k), int(b), "derived"
