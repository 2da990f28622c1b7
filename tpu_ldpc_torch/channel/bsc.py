"""Binary symmetric channel (port of ``tpu_ldpc/channel/bsc.py``).

Each transmitted bit flips independently with probability p.  Receivers
get LLRs, so one decoder interface serves both channels:
llr = (1 - 2*y) * log((1-p)/p).  Every position carries the same
magnitude: BP decoders see a 2-level LLR quantizer.
"""

from __future__ import annotations

import numpy as np
import torch


def bsc_llr_magnitude(p: float) -> float:
    """Per-bit LLR magnitude log((1-p)/p) of a crossover-p BSC."""
    if not 0.0 < p < 0.5:
        raise ValueError(f"crossover probability must be in (0, 0.5), got {p}")
    return float(np.log((1.0 - p) / p))


def bsc_llrs_from_flips(c: torch.Tensor, flips: torch.Tensor,
                        p: float) -> torch.Tensor:
    """LLRs (batch, n) float32 of codewords `c` received with the bits of
    `flips` (0/1 or bool, same shape) inverted."""
    mag = bsc_llr_magnitude(p)
    y = c.to(torch.int32) ^ flips.to(torch.int32)
    return (1.0 - 2.0 * y.to(torch.float32)) * mag


def bsc_llrs(c: torch.Tensor, p: float,
             generator: torch.Generator) -> torch.Tensor:
    """Transmit codewords c (batch, n) over a BSC(p), flips drawn from
    `generator`; return LLRs."""
    flips = torch.rand(c.shape, generator=generator,
                       device=c.device) < p
    return bsc_llrs_from_flips(c, flips, p)
