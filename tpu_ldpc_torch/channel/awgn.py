"""BPSK modulation + AWGN channel + LLR computation (port of
``tpu_ldpc/channel/awgn.py``).

Conventions (shared with the golden model and the JAX package):
  x = 1 - 2c               (bit 0 -> +1, bit 1 -> -1)
  sigma^2 = 1 / (2 * R * 10^(EbN0_dB / 10))
  y = x + sigma * N(0, 1)
  llr = 2 y / sigma^2      (positive favors bit 0)

sigma^2 is computed on the host in float64 and rounded once to float32;
the rest is float32 on the tensor's device, one rounded op at a time
(PyTorch does not contract the multiply into the add).
"""

from __future__ import annotations

import numpy as np
import torch


def noise_sigma2(ebn0_db: float, rate: float) -> float:
    """Noise variance per real dimension."""
    return 1.0 / (2.0 * rate * 10.0 ** (ebn0_db / 10.0))


def bpsk(c: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * c.to(torch.float32)


def llr_constants(ebn0_db: float, rate: float) -> tuple[float, float]:
    """(sigma, 2 / sigma^2) as float32 values: llr = scale * (x + sigma *
    noise)."""
    sigma2 = np.float32(noise_sigma2(float(ebn0_db), rate))
    return float(np.sqrt(sigma2)), float(np.float32(2.0) / sigma2)


def llrs_from_noise(c: torch.Tensor, noise: torch.Tensor, ebn0_db: float,
                    rate: float) -> torch.Tensor:
    """Channel LLRs (batch, n) float32 for codewords `c` and unit-variance
    Gaussian `noise` of the same shape."""
    sigma, scale = llr_constants(ebn0_db, rate)
    return scale * (bpsk(c) + sigma * noise.to(torch.float32))


def awgn_llrs(c: torch.Tensor, ebn0_db: float, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Modulate codewords, add AWGN drawn from `generator`, return LLRs."""
    noise = torch.randn(c.shape, generator=generator, device=c.device,
                        dtype=torch.float32)
    return llrs_from_noise(c, noise, ebn0_db, rate)
