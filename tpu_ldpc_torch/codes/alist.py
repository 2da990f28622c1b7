"""Code-matrix text I/O: .alist and QC shift-table formats (the port's
copy of ``tpu_ldpc/codes/alist.py``).

MacKay ``.alist`` holds an arbitrary sparse H; the compact shift-table
format holds a QC code::

    # optional comments
    mb nb Z
    <mb rows of nb space-separated ints, -1 for a zero block>
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def save_shift_table(code, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"# tpu-ldpc QC shift table: {code.name}\n")
        f.write(f"{code.mb} {code.nb} {code.Z}\n")
        for row in np.asarray(code.B):
            f.write(" ".join(str(int(v)) for v in row) + "\n")


def load_shift_table(path: str, name: str | None = None):
    from tpu_ldpc_torch.codes.code import LdpcCode

    rows = []
    with open(path) as f:
        lines = [
            ln.strip() for ln in f
            if ln.strip() and not ln.lstrip().startswith("#")
        ]
    mb, nb, Z = map(int, lines[0].split())
    for ln in lines[1 : 1 + mb]:
        rows.append([int(v) for v in ln.split()])
    B = np.asarray(rows, dtype=np.int64)
    if B.shape != (mb, nb):
        raise ValueError(f"{path}: expected {mb}x{nb} table, got {B.shape}")
    if (B >= Z).any() or (B < -1).any():
        raise ValueError(f"{path}: shifts must be in [-1, {Z})")
    return LdpcCode(name or path.rsplit("/", 1)[-1], B, Z)


def save_alist(H, path: str) -> None:
    """Write MacKay alist (1-indexed, zero-padded per-column/row lists)."""
    Hc = sp.csc_matrix(H)
    m, n = Hc.shape[0], Hc.shape[1]
    col_lists = [Hc.indices[Hc.indptr[j]:Hc.indptr[j + 1]] + 1
                 for j in range(n)]
    Hr = sp.csr_matrix(H)
    row_lists = [Hr.indices[Hr.indptr[i]:Hr.indptr[i + 1]] + 1
                 for i in range(m)]
    max_c = max((len(c) for c in col_lists), default=0)
    max_r = max((len(r) for r in row_lists), default=0)
    with open(path, "w") as f:
        f.write(f"{n} {m}\n{max_c} {max_r}\n")
        f.write(" ".join(str(len(c)) for c in col_lists) + "\n")
        f.write(" ".join(str(len(r)) for r in row_lists) + "\n")
        for c in col_lists:
            pad = list(c) + [0] * (max_c - len(c))
            f.write(" ".join(map(str, pad)) + "\n")
        for r in row_lists:
            pad = list(r) + [0] * (max_r - len(r))
            f.write(" ".join(map(str, pad)) + "\n")


def load_alist_matrix(path: str) -> sp.csr_matrix:
    """Read a MacKay alist file into a sparse H."""
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)
    n, m = int(next(it)), int(next(it))
    max_c, _max_r = int(next(it)), int(next(it))
    col_deg = [int(next(it)) for _ in range(n)]
    _row_deg = [int(next(it)) for _ in range(m)]
    rows, cols = [], []
    for j in range(n):
        entries = [int(next(it)) for _ in range(max_c)]
        for v in entries[: col_deg[j]]:
            if v > 0:
                rows.append(v - 1)
                cols.append(j)
    data = np.ones(len(rows), dtype=np.uint8)
    return sp.coo_matrix((data, (rows, cols)), shape=(m, n)).tocsr()


def load_alist(path: str, Z: int | None = None, name: str | None = None):
    """Load an alist as an LdpcCode.

    If the matrix is quasi-cyclic with lift Z (given or auto-detected),
    it is decompiled into a base matrix; otherwise raises (the decoders
    need QC structure).
    """
    H = load_alist_matrix(path)
    m, n = H.shape
    if Z is None:
        # auto-detect: largest Z dividing both dims that decompiles cleanly
        for cand in range(min(m, n), 0, -1):
            if m % cand or n % cand:
                continue
            if _try_decompile(H, cand) is not None:
                Z = cand
                break
    B = _try_decompile(H, Z)
    if B is None:
        raise ValueError(f"{path}: not quasi-cyclic with Z={Z}")
    from tpu_ldpc_torch.codes.code import LdpcCode

    return LdpcCode(name or path.rsplit("/", 1)[-1], B, Z)


def _try_decompile(H, Z: int):
    """Return the base matrix if H is QC with lift Z, else None."""
    m, n = H.shape
    if m % Z or n % Z:
        return None
    mb, nb = m // Z, n // Z
    Hd = np.asarray(H.todense())
    B = np.full((mb, nb), -1, dtype=np.int64)
    r = np.arange(Z)
    for i in range(mb):
        for j in range(nb):
            blk = Hd[i * Z:(i + 1) * Z, j * Z:(j + 1) * Z]
            s = blk.sum()
            if s == 0:
                continue
            if s != Z:
                return None
            cols = blk.argmax(axis=1)
            shift = int(cols[0])
            if not (cols == (r + shift) % Z).all():
                return None
            if not (blk[r, cols] == 1).all():
                return None
            B[i, j] = shift
    return B
