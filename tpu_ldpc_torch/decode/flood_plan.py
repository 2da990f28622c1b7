"""Host-side tables of the flooding kernel (``csrc/bp_flood.cu``): which
instantiation runs a code, with how many threads, and the index tables
it loads once per block.

R is stored in variable-aligned coordinates, its edges grouped by
block-column.  The message on edge e (block-row i, block-col j, shift s)
between check r and variable z = (r + s) mod Z lives at
``R[rslot[e] * Z + z]``, where ``rslot`` numbers the edges column by
column and, inside a column, in ascending block-row order (the order of
the VN sum).  Hence:

- CN pass, check c = i*Z + r, slot t of its row (edge e = row_ptr[i] +
  t): it reads ``P[cn_p[t, c]]`` and ``R[cn_r[t, c]]`` with ``cn_p =
  col_e*Z + z`` and ``cn_r = rslot[e]*Z + z``.  The one rotation per
  edge is done here, once.
- VN pass, variable v = j*Z + z: it reads ``R[base + t*Z]`` for t <
  col_deg[j], with ``base = cstart_j*Z + z`` (``vn_info[v]`` packs it
  with col_deg[j]): no wrap at all.

``shifts`` are the shifts the decoder runs with (the layout's, or the
effective shifts of ``decode/normalize.py``); the tables hold state
indices, so shift normalization is a relabeling on top of them.

Instantiations: the largest row degree picks a compile-time bound
``bucket`` (kMaxDeg) of 8, 16 or 32.  Such a kernel runs one check per
thread, the row's indices and messages in registers, so it needs
``m <= MAX_THREADS[bucket]``; buckets above 8 pack a slot's two indices
into 16 bits each, so they also need n and E*Z below 2^16.  Every other
code (a row above 32, more checks than threads) takes bucket 0: the
two-pass loop over any number of checks per thread and any row degree,
which reads the per-edge tables ``row_ptr``, ``e_p`` (col*Z), ``e_r``
(rslot*Z) and ``e_shift`` from shared memory.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from tpu_ldpc_torch.codes.code import LdpcCode

BUCKETS = (8, 16, 32)
# most threads a bucket's kernel may launch (its __launch_bounds__)
MAX_THREADS = {8: 1024, 16: 1024, 32: 512}
GENERIC_THREADS = 256  # bucket 0
PACK_LIMIT = 1 << 16   # buckets above 8: indices in 16 bits
VN_BASE_BITS = 17      # vn_info = (col_deg << 17) | base, as uint32


def choose_bucket(max_row_deg: int, m: int, n: int, r_slots: int) -> int:
    """kMaxDeg of the instantiation that runs a code: the smallest bucket
    that holds its largest row and one check per thread, else 0."""
    for bucket in BUCKETS:
        if (max_row_deg <= bucket and m <= MAX_THREADS[bucket]
                and (bucket == BUCKETS[0]
                     or max(n, r_slots) <= PACK_LIMIT)):
            return bucket
    return 0


@dataclasses.dataclass(frozen=True, eq=False)
class FloodPlan:
    """The kernel's instantiation, block size and index tables (int32;
    cn_p and cn_r hold 0 past a row's degree)."""

    bucket: int
    threads: int         # one per check in whole warps; bucket 0: 256
    cn_p: np.ndarray     # (bucket, m) P index of slot t of check c
    cn_r: np.ndarray     # (bucket, m) R index of slot t of check c
    cn_deg: np.ndarray   # (m,) row degree of check c
    vn_info: np.ndarray  # (n,) uint32 bits: (col_deg << 17) | R of slot 0
    row_ptr: np.ndarray  # (mb+1,) edges of row i: [row_ptr[i], row_ptr[i+1])
    e_p: np.ndarray      # (E,) col_e * Z
    e_r: np.ndarray      # (E,) rslot[e] * Z
    e_shift: np.ndarray  # (E,) the shifts the decoder runs with

    def tables(self) -> dict[str, np.ndarray]:
        """The arrays the kernel reads, in its argument order."""
        return {name: getattr(self, name) for name in (
            "vn_info", "cn_p", "cn_r", "cn_deg", "row_ptr", "e_p", "e_r",
            "e_shift")}


@functools.lru_cache(maxsize=128)
def flood_plan(code: LdpcCode, shifts: tuple) -> FloodPlan:
    """The flooding kernel's plan for `code` run with `shifts` (one per
    edge, in layout order)."""
    lay = code.layout
    Z, mb, nb, E = lay.Z, lay.mb, lay.nb, lay.E
    m, n = mb * Z, nb * Z
    shifts = np.asarray(shifts, dtype=np.int64)
    if shifts.shape != (E,):
        raise ValueError(f"{E} shifts expected, got {shifts.shape}")
    row_ptr = np.asarray(lay.row_ptr, dtype=np.int64)
    col = np.asarray(lay.edge_col, dtype=np.int64)
    col_deg = np.asarray(lay.col_deg, dtype=np.int64)
    # vn_info's limits: 2^17 two-byte messages alone exceed a block's
    # shared memory; a column of degree 2^15 needs 32768 block-rows
    if E * Z >= 1 << VN_BASE_BITS or int(col_deg.max()) >= 1 << (
            32 - VN_BASE_BITS):
        raise ValueError(f"{code.name}: {E * Z} messages or a column of "
                         f"degree {int(col_deg.max())}: beyond the flooding "
                         "kernel's variable table")
    rslot = np.empty(E, dtype=np.int64)
    cstart = np.zeros(nb, dtype=np.int64)
    k = 0
    for j in range(nb):
        cstart[j] = k
        for e in lay.col_edges(j):  # ascending block-row order
            rslot[e] = k
            k += 1
    assert k == E

    deg = np.diff(row_ptr)
    bucket = choose_bucket(int(deg.max()), m, n, E * Z)
    r = np.arange(Z)
    cn_p = np.zeros((bucket, m), dtype=np.int64)
    cn_r = np.zeros((bucket, m), dtype=np.int64)
    for i in range(mb):
        for t, e in enumerate(range(row_ptr[i], row_ptr[i + 1])):
            if t >= bucket:
                break
            z = (r + shifts[e]) % Z
            cn_p[t, i * Z:(i + 1) * Z] = col[e] * Z + z
            cn_r[t, i * Z:(i + 1) * Z] = rslot[e] * Z + z
    v = np.arange(n)
    j = v // Z
    vn_info = (col_deg[j] << VN_BASE_BITS) | (cstart[j] * Z + v % Z)

    def i32(a):
        a = np.ascontiguousarray(np.asarray(a, np.int64).astype(
            np.uint32).view(np.int32))
        a.setflags(write=False)
        return a

    return FloodPlan(
        bucket=bucket,
        threads=max(32, -(-m // 32) * 32) if bucket else GENERIC_THREADS,
        cn_p=i32(cn_p), cn_r=i32(cn_r), cn_deg=i32(np.repeat(deg, Z)),
        vn_info=i32(vn_info), row_ptr=i32(row_ptr), e_p=i32(col * Z),
        e_r=i32(rslot * Z), e_shift=i32(shifts))
