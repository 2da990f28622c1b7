"""Systematic encoders (port of ``tpu_ldpc/encode/encoder.py``).

(a) ``generator``: parity p = u @ M^T over GF(2) as one dense float64
    matrix product followed by mod 2.  Every partial sum is an integer
    <= k < 2^53, so the product is exact on any device and under any
    float32 matmul precision setting (TF32 never applies to float64).
(b) ``dual_diagonal``: O(n) back-substitution over the 802.11n-style
    parity structure every registry code is built with (closing weight-3
    column with shifts (s, 0, s) at block-rows (0, mb//2, mb-1), shift-0
    dual diagonal): summing all block-rows cancels the dual diagonal and
    the two P^s terms, giving p0 = sum_i A_i u, then p_{i+1}
    back-substitutes.  Integer XOR of circulant rolls, no float product.
(c) ``pivot``: the general path for arbitrary H, including rank-deficient
    matrices (terminated SC-LDPC chains): GF(2) row reduction picks a
    pivot / information-set split and the pivot bits are one matrix
    product.  ``encode_fn.k`` is the true dimension n - rank(H) and
    ``encode_fn.info_cols`` maps info bits to codeword positions.

The generator and pivot encoders also carry their parity map on the
host, ``encode_fn.parity_M`` (m, k) 0/1, and ``encode_fn.parity_cols``
(the codeword positions of the parity bits; None: k .. n-1), from which
``sim/mc_batch.py`` packs the Monte-Carlo kernel's table.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device, to_device
from tpu_ldpc_torch.spans import spanned


def _gf2_product(u: torch.Tensor, MT: torch.Tensor) -> torch.Tensor:
    """(u @ MT) mod 2 as uint8, exact in float64."""
    return torch.remainder(u.to(torch.float64) @ MT, 2.0).to(torch.uint8)


@functools.lru_cache(maxsize=64)
@spanned("ldpc.build")
def _build_encoder(code: LdpcCode, method: str, device: torch.device):
    if method == "generator":
        MT = to_device(code, device).parity_MT  # (k, m); raises if singular

        def encode_fn(u: torch.Tensor) -> torch.Tensor:
            u = u.to(torch.uint8)
            return torch.cat([u, _gf2_product(u, MT)], dim=1)

        encode_fn.k = code.k
        encode_fn.info_cols = None
        encode_fn.parity_M, encode_fn.parity_cols = code.parity_M, None
        return encode_fn

    if method == "pivot":
        from tpu_ldpc_torch.codes.gf2 import gf2_row_reduce

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
        encode_fn.parity_M = rref[:rank][:, free]
        encode_fn.parity_cols = pivots
        return encode_fn

    if method == "dual_diagonal":
        B, Z, mb, nb = code.B, code.Z, code.mb, code.nb
        kb = nb - mb
        # closing column structure
        h_rows = [i for i in range(mb) if B[i, kb] >= 0]
        if len(h_rows) != 3 or h_rows[0] != 0 or h_rows[-1] != mb - 1:
            raise ValueError(
                f"{code.name}: parity part is not in dual-diagonal form"
            )
        r_mid = h_rows[1]
        s_top = int(B[0, kb])
        if int(B[r_mid, kb]) != 0 or int(B[mb - 1, kb]) != s_top:
            raise ValueError(
                f"{code.name}: closing column shifts are not (s, 0, s)"
            )
        info_blocks = [
            [(j, int(B[i, j])) for j in range(kb) if B[i, j] >= 0]
            for i in range(mb)
        ]

        def encode_fn(u: torch.Tensor) -> torch.Tensor:
            u = u.to(torch.uint8)
            ub = u.reshape(u.shape[0], kb, Z)
            # s_i = A_i u: XOR of the block-row's rolled info blocks
            s = []
            for i in range(mb):
                acc = torch.zeros_like(ub[:, 0, :])
                for j, sh in info_blocks[i]:
                    acc ^= torch.roll(ub[:, j, :], -sh, dims=-1)
                s.append(acc)
            # p0 = sum of all block-row syndromes
            p0 = s[0].clone()
            for i in range(1, mb):
                p0 ^= s[i]
            # back-substitution
            p = [p0, s[0] ^ torch.roll(p0, -s_top, dims=-1)]
            for i in range(1, mb - 1):
                nxt = s[i] ^ p[i]
                if i == r_mid:
                    nxt ^= p0  # shift-0 closing-column entry
                p.append(nxt)
            return torch.cat([u, torch.cat(p, dim=1)], dim=1)

        encode_fn.k = code.k
        encode_fn.info_cols = None
        return encode_fn

    raise ValueError(f"unknown encode method {method!r}")


def build_encoder(code: LdpcCode, method: str = "generator", *, device):
    """Encoder u (batch, k) uint8 -> c (batch, n) uint8 on `device`."""
    return _build_encoder(code, method, resolve_device(device))


def encode(code: LdpcCode, u, method: str = "generator", device=None):
    """Codewords (batch, n) uint8 of info bits u (batch, k).

    device=None: a tensor stays on its own device; NumPy input goes to
    the card ('cuda', which raises without one) -- pass device='cpu' for
    the CPU.  A given device moves u there (decode()'s rule)."""
    if device is None:
        device = u.device if isinstance(u, torch.Tensor) else "cuda"
    device = resolve_device(device)
    if not isinstance(u, torch.Tensor):
        u = torch.as_tensor(np.asarray(u, dtype=np.uint8))
    return build_encoder(code, method, device=device)(u.to(device))


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
