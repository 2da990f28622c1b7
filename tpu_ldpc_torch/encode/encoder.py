"""Systematic encoders (port of ``tpu_ldpc/encode/encoder.py``).

(a) ``generator``: parity p = u @ M^T over GF(2) as one dense float64
    matrix product followed by mod 2.  Every partial sum is an integer
    <= k < 2^53, so the product is exact on any device and under any
    float32 matmul precision setting (TF32 never applies to float64).
(c) ``pivot``: the general path for arbitrary H, including rank-deficient
    matrices (terminated SC-LDPC chains): GF(2) row reduction picks a
    pivot / information-set split and the pivot bits are one matrix
    product.  ``encode_fn.k`` is the true dimension n - rank(H) and
    ``encode_fn.info_cols`` maps info bits to codeword positions.

The O(n) ``dual_diagonal`` path (b) is not ported yet (ROADMAP Queue 1
item 2).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device, to_device


def _gf2_product(u: torch.Tensor, MT: torch.Tensor) -> torch.Tensor:
    """(u @ MT) mod 2 as uint8, exact in float64."""
    return torch.remainder(u.to(torch.float64) @ MT, 2.0).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _build_encoder(code: LdpcCode, method: str, device: torch.device):
    if method == "generator":
        MT = to_device(code, device).parity_MT  # (k, m); raises if singular

        def encode_fn(u: torch.Tensor) -> torch.Tensor:
            u = u.to(torch.uint8)
            return torch.cat([u, _gf2_product(u, MT)], dim=1)

        encode_fn.k = code.k
        encode_fn.info_cols = None
        return encode_fn

    if method == "pivot":
        from tpu_ldpc.golden.encoder import gf2_row_reduce

        Hd = (np.asarray(sp.csr_matrix(code.H).todense()) % 2).astype(np.uint8)
        n = Hd.shape[1]
        rref, pivots = gf2_row_reduce(Hd)
        rank = len(pivots)
        free = np.asarray(sorted(set(range(n)) - set(pivots)), dtype=np.int64)
        pivots = np.asarray(pivots, dtype=np.int64)
        MT = torch.as_tensor(
            np.ascontiguousarray(rref[:rank][:, free].T), dtype=torch.float64
        ).to(device)
        free_t = torch.as_tensor(free).to(device)
        piv_t = torch.as_tensor(pivots).to(device)

        def encode_fn(u: torch.Tensor) -> torch.Tensor:
            u = u.to(torch.uint8)
            c = torch.zeros((u.shape[0], n), dtype=torch.uint8,
                            device=u.device)
            c[:, free_t] = u
            c[:, piv_t] = _gf2_product(u, MT)
            return c

        encode_fn.k = n - rank
        encode_fn.info_cols = free
        return encode_fn

    if method == "dual_diagonal":
        raise NotImplementedError(
            "encode method 'dual_diagonal' is not ported yet "
            "(ROADMAP Queue 1 item 2); use 'generator' or 'pivot'"
        )
    raise ValueError(f"unknown encode method {method!r}")


def build_encoder(code: LdpcCode, method: str = "generator", *, device):
    """Encoder u (batch, k) uint8 -> c (batch, n) uint8 on `device`."""
    return _build_encoder(code, method, resolve_device(device))


def select_encoder(code: LdpcCode, *, device):
    """The generator path when the trailing parity block is invertible,
    else the pivot path.  Returns (encode_fn, k, info_cols): k is the true
    info dimension; info_cols is None for the generator path (info bits
    are the leading k columns) or the pivot information-set columns."""
    try:
        fn = build_encoder(code, "generator", device=device)
    except ValueError:
        fn = build_encoder(code, "pivot", device=device)
    return fn, fn.k, fn.info_cols
