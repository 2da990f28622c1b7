"""Waterfall reporting: tables, CSV, confidence intervals (the port's copy
of ``tpu_ldpc/report/waterfall.py``)."""

from __future__ import annotations

import io
import math
from typing import Sequence


def wilson_interval(errors: int, trials: int, z: float = 1.96):
    """Wilson score interval for an error probability."""
    if trials == 0:
        return 0.0, 1.0
    p = errors / trials
    denom = 1 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    half = (
        z * math.sqrt(p * (1 - p) / trials + z * z / (4 * trials * trials))
        / denom
    )
    return max(0.0, center - half), min(1.0, center + half)


def waterfall_table(results: Sequence, k: int | None = None) -> str:
    """Markdown table of an Eb/N0 sweep (SnrResult list)."""
    out = io.StringIO()
    out.write(
        "| Eb/N0 (dB) | frames | FER | FER 95% CI | BER | mean iters "
        "| undetected |\n|---|---|---|---|---|---|---|\n"
    )
    for r in results:
        lo, hi = wilson_interval(r.frame_errors, r.frames)
        out.write(
            f"| {r.ebn0_db:.2f} | {r.frames} | {r.fer:.3e} "
            f"| [{lo:.2e}, {hi:.2e}] | {r.ber:.3e} "
            f"| {r.mean_iters:.1f} | {r.undetected} |\n"
        )
    return out.getvalue()


def waterfall_csv(results: Sequence) -> str:
    out = io.StringIO()
    out.write(
        "ebn0_db,frames,bit_errors,frame_errors,detected,undetected,"
        "iter_sum,fer,ber,mean_iters,fer_ci_lo,fer_ci_hi,wall_s\n"
    )
    for r in results:
        lo, hi = wilson_interval(r.frame_errors, r.frames)
        out.write(
            f"{r.ebn0_db},{r.frames},{r.bit_errors},{r.frame_errors},"
            f"{r.detected},{r.undetected},{r.iter_sum},{r.fer:.6e},"
            f"{r.ber:.6e},{r.mean_iters:.3f},{lo:.6e},{hi:.6e},"
            f"{r.wall_s:.3f}\n"
        )
    return out.getvalue()


def load_csv(text: str) -> list[dict]:
    lines = [ln for ln in text.strip().splitlines() if ln]
    header = lines[0].split(",")
    return [
        {h: float(v) for h, v in zip(header, ln.split(","))}
        for ln in lines[1:]
    ]
