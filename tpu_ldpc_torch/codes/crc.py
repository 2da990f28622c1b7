"""Cyclic redundancy check over GF(2) (port of ``tpu_ldpc/codes/crc.py``).

The outer check that gates the Monte-Carlo counters (``sim/mc.py``) and
acknowledges HARQ frames (``sim/harq.py``): a decoder can converge to a
wrong codeword whose syndrome is clean, and only an outer check catches
it.  A CRC is a linear map over GF(2): the r check bits of a k-bit
message are ``G @ u (mod 2)`` for a fixed (r, k) matrix whose column j
is ``x^(k-1-j+r) mod g(x)``.  So the batched check on the device is one
matrix product and a parity test, in float64: every partial sum is an
integer <= k < 2^53, exact on any device and under any float32 matmul
precision setting (TF32 never applies to float64).  The bit-serial LFSR
(``crc_remainder``) is the NumPy ground truth the matrix path is held
to.

Conventions: MSB-first polynomial division, initial register 0, no final
XOR, no bit reflection.  ``attach(u)`` appends ``crc(u)``, so the whole
frame's remainder is 0.  Generator polynomials: CRC-8 ATM/ITU
x^8+x^2+x+1; CRC-16-CCITT x^16+x^12+x^5+1; CRC-24 0x864CFB; CRC-32
(IEEE 802.3).  Custom polynomials: pass a CrcSpec.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpu_ldpc_torch.codes_device import resolve_device


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    """Generator polynomial g(x) of degree `width`; `poly` holds the
    coefficients below x^width, MSB first (the implicit leading 1 is
    NOT stored), e.g. CRC-16-CCITT -> width=16, poly=0x1021."""

    name: str
    width: int
    poly: int

    def poly_bits(self) -> np.ndarray:
        """(width+1,) uint8 coefficients of g(x), degree-high first."""
        bits = [(self.poly >> (self.width - 1 - i)) & 1
                for i in range(self.width)]
        return np.asarray([1] + bits, dtype=np.uint8)


SPECS = {
    "crc8": CrcSpec("crc8", 8, 0x07),
    "crc16": CrcSpec("crc16", 16, 0x1021),
    "crc24": CrcSpec("crc24", 24, 0x864CFB),
    "crc32": CrcSpec("crc32", 32, 0x04C11DB7),
}


def get_spec(spec) -> CrcSpec:
    if isinstance(spec, CrcSpec):
        return spec
    try:
        return SPECS[spec]
    except KeyError:
        raise ValueError(
            f"unknown CRC {spec!r}; known: {sorted(SPECS)} "
            "(or pass a CrcSpec)") from None


def crc_remainder(bits: np.ndarray, spec) -> np.ndarray:
    """Golden bit-serial LFSR: remainder of bits(x)*x^r mod g(x).

    bits: (..., k) uint8, MSB-first message.  Returns (..., r) uint8.
    O(k) per message; ground truth for `crc_matrix`, never the hot
    path.
    """
    spec = get_spec(spec)
    bits = np.asarray(bits, dtype=np.uint8)
    b = bits.reshape(-1, bits.shape[-1])
    r = spec.width
    reg = np.zeros((b.shape[0], r), dtype=np.uint8)
    gen = spec.poly_bits()[1:]  # low coefficients, MSB first
    for j in range(b.shape[-1]):
        msb = reg[:, 0] ^ b[:, j]
        reg = np.roll(reg, -1, axis=1)
        reg[:, -1] = 0
        reg ^= msb[:, None] * gen[None, :]
    return reg.reshape(bits.shape[:-1] + (r,))


@functools.lru_cache(maxsize=32)
def crc_matrix(k: int, spec_key) -> np.ndarray:
    """(r, k) uint8 generator matrix: crc(u) = M @ u mod 2.

    Column j is x^(k-1-j+r) mod g(x), built by one incremental
    multiply-by-x sweep (O(k·r), cached).  Hashable spec_key: a name
    from SPECS or a CrcSpec.
    """
    spec = get_spec(spec_key)
    r = spec.width
    gen = spec.poly_bits()[1:].astype(np.uint8)
    # power = x^r mod g  (start: column k-1, the LAST message bit)
    power = gen.copy()
    cols = np.empty((k, r), dtype=np.uint8)
    for j in range(k):
        cols[k - 1 - j] = power
        # power <- power * x mod g
        msb = power[0]
        power = np.roll(power, -1)
        power[-1] = 0
        if msb:
            power ^= gen
    return np.ascontiguousarray(cols.T)


def check_matrix(k_total: int, spec) -> np.ndarray:
    """(r, k_total) matrix M with: frame [u | crc(u)] passes iff
    M @ frame == 0 (mod 2).  M = [crc_matrix(k_total-r) | I_r]."""
    spec = get_spec(spec)
    r = spec.width
    if k_total <= r:
        raise ValueError(f"frame length {k_total} <= CRC width {r}")
    m = np.zeros((r, k_total), dtype=np.uint8)
    m[:, : k_total - r] = crc_matrix(k_total - r, spec)
    m[:, k_total - r:] = np.eye(r, dtype=np.uint8)
    return m


def attach(payload: np.ndarray, spec) -> np.ndarray:
    """(..., k) uint8 payload -> (..., k+r) frame with CRC appended."""
    payload = np.asarray(payload, dtype=np.uint8)
    return np.concatenate(
        [payload, crc_remainder(payload, spec)], axis=-1)


def check(frame: np.ndarray, spec) -> np.ndarray:
    """Golden check: (..., k_total) -> (...,) bool, True = CRC pass."""
    spec = get_spec(spec)
    frame = np.asarray(frame, dtype=np.uint8)
    m = check_matrix(frame.shape[-1], spec)
    return ((frame @ m.T) % 2 == 0).all(axis=-1)


def make_crc_checker(k_total: int, spec, *, device):
    """Batched checker on `device`: (batch, k_total) uint8 -> (batch,)
    bool, True = CRC pass.  One float64 product against check_matrix's
    transpose, then a parity test."""
    mt = torch.as_tensor(check_matrix(k_total, get_spec(spec)).T,
                         dtype=torch.float64).to(resolve_device(device))

    def crc_ok(bits: torch.Tensor) -> torch.Tensor:
        s = bits.to(torch.float64) @ mt
        return (torch.remainder(s, 2.0) == 0.0).all(dim=-1)

    return crc_ok


def make_crc_attacher(k_payload: int, spec, *, device):
    """Batched attach on `device`: (batch, k_payload) uint8 -> (batch,
    k_payload + r) uint8 frame [payload | crc(payload)], one float64
    product as the checker."""
    mt = torch.as_tensor(crc_matrix(k_payload, get_spec(spec)).T,
                         dtype=torch.float64).to(resolve_device(device))

    def attach_fn(payload: torch.Tensor) -> torch.Tensor:
        c = torch.remainder(payload.to(torch.float64) @ mt, 2.0)
        return torch.cat([payload, c.to(payload.dtype)], dim=-1)

    return attach_fn
