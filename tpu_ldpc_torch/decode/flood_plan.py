"""Host-side tables of the flooding kernels: which instantiation of
``csrc/bp_flood.cu`` runs a code, with how many threads, and the index
tables it loads once per block; and the same for the compressed-state
kernel ``csrc/bp_compressed.cu`` (``compressed_plan``, at the end).

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
(rslot*Z) and ``e_shift`` from shared memory.  Its second pass sends
from the signs of the first pass's q, kept in one register, where every
row has at most ``SIGN_SLOTS`` slots and the CN update's output reads q
only through its sign (``one_gather``); exact sum-product and longer rows
recompute q there.

A code whose block state (``flood_smem_bytes`` in its bucket) exceeds
``SMEM_LIMIT_BYTES`` runs the device-memory kernel (``bp_flood_gmem_kernel``)
on the same plan: R of each codeword in a scratch buffer in device
memory, the VN table read from ``vn_info`` itself, and bucket 0's two-pass
rows over ``row_ptr`` / ``e_*`` whatever the bucket.  ``gmem_placement``
puts L and P beside the row tables in shared memory where they fit
(``flood_gmem_smem_bytes``), one block of ``GMEM_SHARED_LP_THREADS`` an SM,
so that the resident codewords' R fits the L2; else in the scratch before
R, on blocks of ``GENERIC_THREADS``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.spans import spanned

BUCKETS = (8, 16, 32)
# most threads a bucket's kernel may launch (its __launch_bounds__)
MAX_THREADS = {8: 1024, 16: 1024, 32: 512}
GENERIC_THREADS = 256  # bucket 0
SIGN_SLOTS = 32        # bucket 0: a row's q signs in one 32-bit register
PACK_LIMIT = 1 << 16   # buckets above 8: indices in 16 bits
VN_BASE_BITS = 17      # vn_info = (col_deg << 17) | base, as uint32
SMEM_LIMIT_BYTES = 232_448  # 227 KB: the most one Hopper block may use
GMEM_STATE_ALIGN = 256      # the device-memory kernel: bytes a state rounds to
# its block with L and P in shared memory, one an SM (512 threads ran
# 1.59x slower on the H100: the L2's latency wants the warps)
GMEM_SHARED_LP_THREADS = 1024


def flood_smem_bytes(Z: int, mb: int, nb: int, E: int, bucket: int,
                     msg_bf16: bool = False) -> int:
    """Shared memory of one flooding block: L, P and the VN table (4 B a
    variable each), bucket 0's per-edge tables (row_ptr and three per
    edge), and R in float32 or bf16.  The C entry point
    ldpc_bp_flood_smem_bytes computes the same."""
    return (3 * nb * Z * 4 + ((mb + 1 + 3 * E) * 4 if bucket == 0 else 0)
            + E * Z * (2 if msg_bf16 else 4))


def code_flood_smem_bytes(code: LdpcCode) -> int:
    """flood_smem_bytes of `code` in its bucket, float32 messages: above
    SMEM_LIMIT_BYTES the flooding kernel cannot run it."""
    lay = code.layout
    m, n, E = lay.mb * lay.Z, lay.nb * lay.Z, lay.E
    return flood_smem_bytes(lay.Z, lay.mb, lay.nb, E,
                            choose_bucket(lay.max_row_deg, m, n, E * lay.Z))


def flood_gmem_state_bytes(Z: int, nb: int, E: int, msg_bf16: bool = False,
                           shared_lp: bool = False) -> int:
    """Device memory of one codeword's state in the device-memory kernel:
    R in float32 or bf16 and, unless `shared_lp`, L and P (4 B a variable
    each), rounded up to GMEM_STATE_ALIGN.  The decoder allocates batch
    times this and passes it to ldpc_bp_flood_gmem as the stride between
    codewords."""
    nbytes = (0 if shared_lp else 2 * nb * Z * 4) + E * Z * (
        2 if msg_bf16 else 4)
    return -(-nbytes // GMEM_STATE_ALIGN) * GMEM_STATE_ALIGN


def flood_gmem_smem_bytes(Z: int, mb: int, nb: int, E: int,
                          shared_lp: bool) -> int:
    """Shared memory of one device-memory kernel's block: bucket 0's
    per-edge tables (row_ptr and three per edge) and, with `shared_lp`, L
    and P (4 B a variable each).  The C entry point
    ldpc_bp_flood_gmem_smem_bytes computes the same."""
    return (2 * nb * Z * 4 if shared_lp else 0) + (mb + 1 + 3 * E) * 4


@dataclasses.dataclass(frozen=True)
class GmemPlacement:
    """Where the device-memory kernel keeps a codeword's state."""

    shared_lp: bool  # L and P in shared memory, R alone in the scratch
    threads: int     # a block: GMEM_SHARED_LP_THREADS, else GENERIC_THREADS
    stride: int      # scratch a codeword (flood_gmem_state_bytes)


def gmem_placement(Z: int, mb: int, nb: int, E: int, msg_bf16: bool = False,
                   limit: int = SMEM_LIMIT_BYTES) -> GmemPlacement:
    """The device-memory kernel's placement: L and P in shared memory
    where they and the row tables fit in `limit` bytes, else in the
    scratch."""
    shared_lp = flood_gmem_smem_bytes(Z, mb, nb, E, True) <= limit
    return GmemPlacement(
        shared_lp=shared_lp,
        threads=GMEM_SHARED_LP_THREADS if shared_lp else GENERIC_THREADS,
        stride=flood_gmem_state_bytes(Z, nb, E, msg_bf16, shared_lp))


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


def _column_slots(lay):
    """(rslot, cstart): the edges numbered column by column, inside a
    column in ascending block-row order (the order of the VN sum), and
    each column's first number."""
    rslot = np.empty(lay.E, dtype=np.int64)
    cstart = np.zeros(lay.nb, dtype=np.int64)
    k = 0
    for j in range(lay.nb):
        cstart[j] = k
        for e in lay.col_edges(j):  # ascending block-row order
            rslot[e] = k
            k += 1
    assert k == lay.E
    return rslot, cstart


def _vn_info(lay, cstart):
    """(n,) per variable v = j*Z + z: (col_deg[j] << VN_BASE_BITS) |
    (cstart[j]*Z + z), the first of its column's edge slots."""
    Z = lay.Z
    col_deg = np.asarray(lay.col_deg, dtype=np.int64)
    # vn_info's limits: 2^17 messages (NR BG1 at Z = 384 has 74,112); a
    # column of degree 2^15 needs 32768 block-rows
    if lay.E * Z >= 1 << VN_BASE_BITS or int(col_deg.max()) >= 1 << (
            32 - VN_BASE_BITS):
        raise ValueError(f"{lay.E * Z} messages or a column of degree "
                         f"{int(col_deg.max())}: beyond the variable table")
    v = np.arange(lay.nb * Z)
    j = v // Z
    return (col_deg[j] << VN_BASE_BITS) | (cstart[j] * Z + v % Z)


def i32(a):
    """A read-only contiguous int32 copy (uint32 bit patterns kept)."""
    a = np.ascontiguousarray(np.asarray(a, np.int64).astype(
        np.uint32).view(np.int32))
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=128)
@spanned("ldpc.build")
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
    rslot, cstart = _column_slots(lay)
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
    return FloodPlan(
        bucket=bucket,
        threads=max(32, -(-m // 32) * 32) if bucket else GENERIC_THREADS,
        cn_p=i32(cn_p), cn_r=i32(cn_r), cn_deg=i32(np.repeat(deg, Z)),
        vn_info=i32(_vn_info(lay, cstart)), row_ptr=i32(row_ptr),
        e_p=i32(col * Z), e_r=i32(rslot * Z), e_shift=i32(shifts))


def one_gather(plan: FloodPlan, algo: str, gmem: bool) -> bool:
    """Whether a flooding launch on `plan` (`gmem`: K1g) runs every row
    in bucket 0's one-gather form: the two-pass rows (bucket 0, or K1g
    whatever the bucket) with no row above SIGN_SLOTS slots, under a CN
    update whose output reads q only through its sign (every `algo` but
    exact sum-product).  GenericRows::cn_pass in csrc/bp_flood.cu takes
    the form from the same facts, row by row."""
    return ((plan.bucket == 0 or gmem) and algo != "sumproduct"
            and int(np.diff(plan.row_ptr).max()) <= SIGN_SLOTS)


# compressed row state (csrc/bp_compressed.cu): rows of degree <= 8
COMPRESSED_SLOTS = 8
COMPRESSED_MAX_THREADS = 1024  # one check per thread up to this many
COMPRESSED_GENERIC_THREADS = 256
COMPRESSED_STATE_BYTES = 16    # (m1', m2', argmin | signs << 8, unused)


@dataclasses.dataclass(frozen=True, eq=False)
class CompressedPlan:
    """The compressed-state kernel's form, block size and tables (int32).

    One check per thread (``one_check``): the thread keeps its row's P
    indices (``cn_p``) in registers for the whole decode, and the block
    loads the per-variable tables into shared memory.  Otherwise (more
    checks than COMPRESSED_MAX_THREADS, or tables beyond shared memory)
    256 threads walk the checks and read every table from device memory.
    """

    one_check: bool
    threads: int
    smem: int             # bytes of shared memory per block
    cn_p: np.ndarray      # (8, m) P index of slot t of check c
    cn_deg: np.ndarray    # (m,) row degree of check c
    vn_info: np.ndarray   # (n,) (col_deg << 17) | first edge slot of v
    vn_check: np.ndarray  # (E*Z,) edge slot k*Z + z of the variable
                          # (j, z): (check << 3) | slot in its row

    def tables(self) -> dict[str, np.ndarray]:
        """The arrays the kernel reads, in its argument order."""
        return {name: getattr(self, name) for name in (
            "cn_p", "cn_deg", "vn_info", "vn_check")}


def compressed_smem_bytes(m: int, n: int, edge_slots: int,
                          one_check: bool) -> int:
    """Row state (16 B a check), L and P, and with one check per thread
    the per-variable tables (vn_info, vn_check).  The C entry point
    ldpc_bp_compressed_smem_bytes computes the same."""
    return (COMPRESSED_STATE_BYTES * m + 8 * n
            + (4 * n + 4 * edge_slots if one_check else 0))


@functools.lru_cache(maxsize=64)
@spanned("ldpc.build")
def compressed_plan(code: LdpcCode) -> CompressedPlan:
    """The compressed-state kernel's plan for `code` (its own
    coordinates: compressed state ignores shift normalization)."""
    lay = code.layout
    Z, mb, E = lay.Z, lay.mb, lay.E
    m, n = mb * Z, lay.nb * Z
    if lay.max_row_deg > COMPRESSED_SLOTS:
        raise ValueError(f"{code.name}: rows of degree {lay.max_row_deg}; "
                         f"the sign byte holds {COMPRESSED_SLOTS}")
    row_ptr = np.asarray(lay.row_ptr, dtype=np.int64)
    col = np.asarray(lay.edge_col, dtype=np.int64)
    shift = np.asarray(lay.edge_shift, dtype=np.int64)
    rslot, cstart = _column_slots(lay)
    r = np.arange(Z)
    cn_p = np.zeros((COMPRESSED_SLOTS, m), dtype=np.int64)
    vn_check = np.zeros(E * Z, dtype=np.int64)
    for i in range(mb):
        for t, e in enumerate(range(row_ptr[i], row_ptr[i + 1])):
            cn_p[t, i * Z:(i + 1) * Z] = col[e] * Z + (r + shift[e]) % Z
            # variable z of the column meets check (z - s) mod Z of row i
            vn_check[rslot[e] * Z + r] = (i * Z + (r - shift[e]) % Z) << 3 | t
    one_check = (m <= COMPRESSED_MAX_THREADS and compressed_smem_bytes(
        m, n, E * Z, True) <= SMEM_LIMIT_BYTES)
    return CompressedPlan(
        one_check=one_check,
        threads=(max(32, -(-m // 32) * 32) if one_check
                 else COMPRESSED_GENERIC_THREADS),
        smem=compressed_smem_bytes(m, n, E * Z, one_check),
        cn_p=i32(cn_p), cn_deg=i32(np.repeat(np.diff(row_ptr), Z)),
        vn_info=i32(_vn_info(lay, cstart)), vn_check=i32(vn_check))
