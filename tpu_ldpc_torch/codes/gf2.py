"""GF(2) linear algebra and the systematic NumPy encoder (the port's copy
of ``tpu_ldpc/golden/encoder.py``: row reduction, rank, inverse, parity
map, ``encode``).  These are the plain versions of the native helper's
bit-packed routines (``tpu_ldpc_torch/_native``).

Encoding convention: codeword c = [u | p] with u the k info bits first,
p the m parity bits last; H [A | B] c^T = 0  =>  p = B^{-1} A u (GF(2)).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def gf2_row_reduce(M: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Row-reduce M over GF(2). Returns (rref, pivot_cols)."""
    M = (np.asarray(M) % 2).astype(np.uint8).copy()
    rows, cols = M.shape
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot_rows = np.nonzero(M[r:, c])[0]
        if len(pivot_rows) == 0:
            continue
        pr = r + pivot_rows[0]
        if pr != r:
            M[[r, pr]] = M[[pr, r]]
        # eliminate c from all other rows
        hit = np.nonzero(M[:, c])[0]
        hit = hit[hit != r]
        M[hit] ^= M[r]
        pivots.append(c)
        r += 1
    return M, pivots


def gf2_rank(M: np.ndarray) -> int:
    _, pivots = gf2_row_reduce(M)
    return len(pivots)


def gf2_inv(M: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix (raises ValueError if singular)."""
    M = (np.asarray(M) % 2).astype(np.uint8)
    m = M.shape[0]
    aug = np.concatenate([M, np.eye(m, dtype=np.uint8)], axis=1)
    rref, pivots = gf2_row_reduce(aug)
    if pivots[:m] != list(range(m)):
        raise ValueError("matrix is singular over GF(2)")
    return rref[:, m:]


def parity_map(H) -> np.ndarray:
    """Return M (m x k) with p = M @ u over GF(2), for H = [A | B]."""
    Hd = np.asarray(sp.csr_matrix(H).todense(), dtype=np.uint8) % 2
    m, n = Hd.shape
    k = n - m
    A, B = Hd[:, :k], Hd[:, k:]
    Binv = gf2_inv(B)
    # float64 BLAS, exact: every partial sum is an integer <= m < 2^53
    # (NumPy's int64 product does not use BLAS and is some 500x slower on
    # the NR-like mothers at Z=64)
    return ((Binv.astype(np.float64) @ A.astype(np.float64)) % 2).astype(
        np.uint8)


def encode(H, u: np.ndarray, M: np.ndarray | None = None) -> np.ndarray:
    """Systematic encode on the host. u: (batch, k) -> c: (batch, n)."""
    u = (np.asarray(u) % 2).astype(np.uint8)
    if u.ndim == 1:
        u = u[None, :]
    if M is None:
        M = parity_map(H)
    # float32 BLAS is exact here: 0/1 entries, partial sums <= k < 2^24
    p = (u.astype(np.float32) @ M.T.astype(np.float32)) % 2
    return np.concatenate([u, p.astype(np.uint8)], axis=1)
