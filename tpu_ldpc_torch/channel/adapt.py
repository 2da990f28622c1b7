"""Rate-compatible puncturing and shortening (port of
``tpu_ldpc/channel/adapt.py``).

Several operating rates from one mother code, the 802.16e way: puncture
parity blocks (raise the rate) and/or shorten info blocks (lower the
rate and the block length).  A channel transform only: H, the layouts
and the decode kernels are untouched.  Punctured positions enter the
decoder as erasures (LLR +0.0); shortened positions are known zeros
(LLR +SHORT_LLR).  Neither kind is transmitted, so Eb/N0 is referenced
to the effective rate k_eff / n_tx.

Coordinate spaces:
  * `puncture` indexes CODEWORD positions (0..n-1).
  * `shorten` indexes INFO positions (0..k-1) of the encoder's `u`;
    the codeword position of info bit i is i for the systematic
    generator path, or `info_cols[i]` for the pivot path -- `masks()`
    resolves this.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ldpc_torch.channel.awgn import llrs_from_noise

# Known-bit LLR magnitude.  Safe for every decoder here: min-sum message
# magnitudes never exceed their inputs, and the sum-product phi clamps
# its argument to [SP_MIN_MAG, SP_MAX_MAG] before log/tanh.
SHORT_LLR = 1.0e4


@dataclasses.dataclass(frozen=True)
class RateAdapt:
    """Puncture/shorten spec for a mother code (hashable: it keys the
    MC step cache)."""

    puncture: tuple[int, ...] = ()  # codeword positions, not transmitted
    # info positions, fixed to 0, not transmitted
    shorten: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "puncture", tuple(sorted(set(self.puncture))))
        object.__setattr__(self, "shorten", tuple(sorted(set(self.shorten))))

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_blocks(code, puncture_blocks=(), shorten_blocks=()):
        """Block-column granularity spec for a systematic QC code.

        `shorten_blocks` must name information block-columns
        (0 <= b < nb - mb); `puncture_blocks` may name any block-column
        (parity blocks are the usual choice).
        """
        Z, nb, kb = code.Z, code.nb, code.nb - code.mb
        for b in shorten_blocks:
            if not 0 <= b < kb:
                raise ValueError(
                    f"shorten block {b} is not an info block (0..{kb - 1})"
                )
        for b in puncture_blocks:
            if not 0 <= b < nb:
                raise ValueError(
                    f"puncture block {b} out of range (0..{nb - 1})")
        if set(puncture_blocks) & set(shorten_blocks):
            raise ValueError("a block cannot be both punctured and shortened")
        punct = [p for b in sorted(set(puncture_blocks))
                 for p in range(b * Z, (b + 1) * Z)]
        short = [s for b in sorted(set(shorten_blocks))
                 for s in range(b * Z, (b + 1) * Z)]
        return RateAdapt(puncture=tuple(punct), shorten=tuple(short))

    # --- derived ------------------------------------------------------------
    def dims(self, n: int, k: int) -> tuple[int, int]:
        """(k_eff, n_tx): effective info bits and transmitted bits."""
        k_eff = k - len(self.shorten)
        n_tx = n - len(self.puncture) - len(self.shorten)
        if k_eff <= 0:
            raise ValueError("shortening removes every information bit")
        if n_tx <= k_eff:
            raise ValueError(
                f"adaptation leaves n_tx={n_tx} <= k_eff={k_eff}: rate >= 1"
            )
        return k_eff, n_tx

    def rate(self, n: int, k: int) -> float:
        k_eff, n_tx = self.dims(n, k)
        return k_eff / n_tx

    def masks(self, n: int, k: int, info_cols=None):
        """Static numpy masks for the MC step.

        Returns (tx_mask (n,) f32, known_llr (n,) f32, active_u (k,) u8):
        tx_mask is 1 on transmitted positions; known_llr is +SHORT_LLR on
        shortened codeword positions; active_u is 0 on shortened info
        positions of `u`.
        """
        for p in self.puncture:
            if not 0 <= p < n:
                raise ValueError(f"puncture position {p} out of range (n={n})")
        for s in self.shorten:
            if not 0 <= s < k:
                raise ValueError(f"shorten position {s} out of range (k={k})")
        short_idx = np.asarray(self.shorten, dtype=np.int64)
        if info_cols is not None and short_idx.size:
            short_cw = np.asarray(info_cols, dtype=np.int64)[short_idx]
        else:
            short_cw = short_idx
        punct_cw = np.asarray(self.puncture, dtype=np.int64)
        if np.intersect1d(punct_cw, short_cw).size:
            raise ValueError("puncture and shorten positions overlap")
        tx_mask = np.ones(n, dtype=np.float32)
        tx_mask[punct_cw] = 0.0
        tx_mask[short_cw] = 0.0
        known_llr = np.zeros(n, dtype=np.float32)
        known_llr[short_cw] = SHORT_LLR
        active_u = np.ones(k, dtype=np.uint8)
        active_u[short_idx] = 0
        return tx_mask, known_llr, active_u


def adapted_llrs_from_noise(c: torch.Tensor, noise: torch.Tensor,
                            ebn0_db: float, rate_tx: float,
                            tx_mask: torch.Tensor,
                            known_llr: torch.Tensor) -> torch.Tensor:
    """LLRs of an adapted code for codewords `c` and unit-variance
    Gaussian `noise`: punctures erased, shortened positions saturated.

    ``llrs_from_noise(...) * tx_mask + known_llr`` in float32, one rounded
    op at a time, so an erased position is exactly +0.0 (y * 0 + 0.0).
    Noise power is referenced to the effective transmitted rate, so the
    Eb/N0 axis counts only the energy sent per effective info bit."""
    return (llrs_from_noise(c, noise, ebn0_db, rate_tx) * tx_mask
            + known_llr)


def adapted_awgn_llrs(c: torch.Tensor, ebn0_db: float, rate_tx: float,
                      tx_mask: torch.Tensor, known_llr: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """Modulate, add AWGN drawn from `generator`, erase and saturate."""
    noise = torch.randn(c.shape, generator=generator, device=c.device,
                        dtype=torch.float32)
    return adapted_llrs_from_noise(c, noise, ebn0_db, rate_tx, tx_mask,
                                   known_llr)
