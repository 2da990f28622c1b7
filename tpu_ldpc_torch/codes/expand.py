"""QC lifting: expand a base matrix to the full parity-check matrix
(the port's copy of ``tpu_ldpc/codes/expand.py``).

Convention (see codes/base_graphs.py): entry s lifts to the circulant P^s
with P^s[r, c] = 1 iff c == (r + s) % Z, i.e. check r of a block-row
touches variable (r + s) % Z of the block-column; as an operator on a
length-Z vector v, (P^s v)[r] = v[(r + s) % Z] = roll(v, -s).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def expand(B: np.ndarray, Z: int) -> sp.csr_matrix:
    """Expand base matrix B (mb x nb, -1 = zero block) to H (mb*Z x nb*Z)."""
    B = np.asarray(B)
    mb, nb = B.shape
    ii, jj = np.nonzero(B >= 0)
    shifts = B[ii, jj]
    r = np.arange(Z)
    # rows: block_row*Z + r ; cols: block_col*Z + (r + s) % Z
    rows = (ii[:, None] * Z + r[None, :]).ravel()
    cols = (jj[:, None] * Z + (r[None, :] + shifts[:, None]) % Z).ravel()
    data = np.ones(rows.shape, dtype=np.uint8)
    H = sp.coo_matrix((data, (rows, cols)), shape=(mb * Z, nb * Z))
    return H.tocsr()


def rotate(v: np.ndarray, s: int) -> np.ndarray:
    """Apply P^s to vector(s) along the last axis: out[r] = v[(r+s)%Z]."""
    return np.roll(v, -s, axis=-1)
