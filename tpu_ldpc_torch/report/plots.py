"""Waterfall plotting (the port's copy of ``tpu_ldpc/report/plots.py``;
optional: matplotlib if present)."""

from __future__ import annotations

from typing import Sequence


def plot_waterfall(
    runs: dict[str, Sequence],
    out_path: str,
    title: str = "BER/FER waterfall",
    metric: str = "fer",
):
    """Plot FER (or BER) vs Eb/N0 for one or more sweeps.

    runs: label -> list[SnrResult] (``sim/mc.py``).  Returns the path, or
    None if matplotlib is unavailable (plots are optional).
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None

    fig, ax = plt.subplots(figsize=(6, 4.5))
    for label, results in runs.items():
        xs = [r.ebn0_db for r in results]
        ys = [getattr(r, metric) for r in results]
        ax.semilogy(xs, ys, marker="o", label=label)
    ax.set_xlabel("Eb/N0 (dB)")
    ax.set_ylabel(metric.upper())
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
