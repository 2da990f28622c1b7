"""Host-side tables of the layered kernel (``csrc/bp_layered.cu``): which
instantiation runs a code, how many codewords share a block, and the
index table the block loads once.

The layered schedule updates block-row i's Z checks in parallel, one
thread per check r, the block-rows one after another.  Thread r of a
codeword touches, over a sweep, the messages of its E edges (one per
edge of the base graph) and the variable each edge reaches in P:

- R is kept per check, ``R[r * r_stride + e]``: a thread's messages lie
  side by side, so slot t of a row is a fixed offset from the row's first
  edge, and ``r_stride`` is chosen so that the 32 threads of a warp read
  32 different banks (an odd number of 32-bit words between two checks).
- ``p_idx[r, e] = col_e * Z + (r + s_e) mod Z`` is the P index of edge e
  for check r, rotated once here: the kernel's loop has no wrap, no
  division and no load of per-edge metadata from device memory.  It is
  stored as uint16 (P itself must fit a block's shared memory, so n <
  2^16), with ``idx_stride`` chosen for the same conflict-free reads, and
  loaded into shared memory once per block, where ``group`` codewords
  share it.

``shifts`` are the shifts the decoder runs with (the layout's, or the
effective shifts of ``decode/normalize.py``).

Instantiations: the largest row degree picks a compile-time bound
``bucket`` (kMaxDeg) of 8, 16 or 32, under which a thread keeps its row's
q (and indices) in registers and updates the row in one pass.  A code
whose rows exceed 32, whose Z exceeds the block cap, or whose index table
does not fit beside one codeword's state takes bucket 0: two passes over
each row of any degree, its indices computed from the per-edge offsets
``e_p`` (col_e * Z) and shifts (``e_shift``) in shared memory, and
``Z > MAX_BLOCK_THREADS`` checks walked by fewer threads.

K2g (``bp_layered_gmem_kernel``), for a code whose state exceeds one
block's shared memory, reads the same plan's row pointer and per-edge
tables; ``layered_gmem_placement`` gives its block and scratch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.decode.flood_plan import (
    GMEM_STATE_ALIGN, SMEM_LIMIT_BYTES, i32)
from tpu_ldpc_torch.spans import spanned

BUCKETS = (8, 16, 32)
MAX_BLOCK_THREADS = 256   # the kernel's __launch_bounds__
GMEM_MAX_THREADS = 512    # K2g's __launch_bounds__
SM_SMEM_BYTES = 233_472      # shared memory of one SM
SM_BLOCK_RESERVED = 1_024    # set aside per resident block
SM_MAX_THREADS = 2_048
SM_MAX_BLOCKS = 32


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def conflict_free_stride(count: int, itemsize: int) -> int:
    """The least stride >= count (in items of `itemsize` bytes, 2 or 4)
    whose length in 32-bit words is odd: 32 consecutive checks then read
    32 different banks."""
    stride = count
    if itemsize == 4:
        return stride | 1
    while stride % 4 != 2:  # uint16 / bf16: an odd number of words
        stride += 1
    return stride


def smem_bytes(Z: int, mb: int, nb: int, E: int, bucket: int, group: int,
               idx_stride: int, r_stride: int, msg_bytes: int) -> int:
    """Shared memory of one block: the index table (bucket > 0) or the
    per-edge offsets and shifts (bucket 0), the row pointer, then per
    codeword P and R, then two violation flags per codeword.  The C
    entry point ldpc_bp_layered_smem_bytes computes the same."""
    table = (_align16(Z * idx_stride * 2) if bucket
             else _align16(2 * E * 4))
    per_cw = _align16(nb * Z * 4) + _align16(Z * r_stride * msg_bytes)
    return table + _align16((mb + 1) * 4) + group * per_cw + 2 * group * 4


def choose_group(block_bytes, threads_of) -> int:
    """Codewords per block: the most codewords resident on one SM by
    shared memory, threads and blocks, the fewest per block among ties
    (a block runs until its slowest codeword is done).  0 if one
    codeword does not fit."""
    best, best_res = 0, 0
    g = 1
    while threads_of(g) <= MAX_BLOCK_THREADS or g == 1:
        nbytes = block_bytes(g)
        if nbytes > SMEM_LIMIT_BYTES:
            break
        blocks = min(SM_SMEM_BYTES // (nbytes + SM_BLOCK_RESERVED),
                     SM_MAX_THREADS // threads_of(g), SM_MAX_BLOCKS)
        if g * blocks > best_res:
            best, best_res = g, g * blocks
        g += 1
    return best


@dataclasses.dataclass(frozen=True, eq=False)
class LayeredPlan:
    """The kernel's instantiation, block shape and tables (int32 unless
    said otherwise)."""

    bucket: int          # kMaxDeg: 8, 16, 32, or 0 for the two-pass form
    group: int           # codewords per block
    cw_threads: int      # threads per codeword: min(Z, MAX_BLOCK_THREADS)
    threads: int         # group * cw_threads in whole warps
    idx_stride: int      # entries between two checks' rows of p_idx
    r_stride: int        # messages between two checks' rows of R
    smem: int            # bytes of shared memory per block
    p_idx: np.ndarray    # (Z, idx_stride) uint16 P index of edge e, check r;
                         # (0, idx_stride) in bucket 0
    row_ptr: np.ndarray  # (mb+1,)
    e_p: np.ndarray      # (E,) col_e * Z
    e_shift: np.ndarray  # (E,) the shifts the decoder runs with

    def tables(self) -> dict[str, np.ndarray]:
        """The arrays the kernel reads, in its argument order."""
        return {name: getattr(self, name) for name in (
            "p_idx", "row_ptr", "e_p", "e_shift")}


@functools.lru_cache(maxsize=128)
@spanned("ldpc.build")
def layered_plan(code: LdpcCode, shifts: tuple, msg_bytes: int = 4,
                 early_stop: bool = False) -> LayeredPlan:
    """The layered kernel's plan for `code` run with `shifts` (one per
    edge, in layout order), R messages of `msg_bytes` (4: float32, 2:
    bf16) and early termination on or off.

    With ET off every codeword runs every iteration, so a block takes the
    group that packs the most codewords on an SM.  With ET on a block runs
    until its slowest codeword is done, so it takes the fewest codewords
    that fill a warp (measured faster on the judged code, PERF.md)."""
    lay = code.layout
    Z, mb, nb, E = lay.Z, lay.mb, lay.nb, lay.E
    shifts = np.asarray(shifts, dtype=np.int64)
    if shifts.shape != (E,):
        raise ValueError(f"{E} shifts expected, got {shifts.shape}")
    if msg_bytes not in (2, 4):
        raise ValueError(f"msg_bytes must be 2 or 4, got {msg_bytes}")
    row_ptr = np.asarray(lay.row_ptr, dtype=np.int64)
    col = np.asarray(lay.edge_col, dtype=np.int64)
    cw_threads = min(Z, MAX_BLOCK_THREADS)
    idx_stride = conflict_free_stride(E, 2)
    r_stride = conflict_free_stride(E, msg_bytes)

    def threads_of(g):
        return -(-g * cw_threads // 32) * 32

    def group_for(bucket):
        return choose_group(lambda g: smem_bytes(
            Z, mb, nb, E, bucket, g, idx_stride, r_stride, msg_bytes),
            threads_of)

    bucket = next((b for b in BUCKETS if lay.max_row_deg <= b), 0)
    if Z > MAX_BLOCK_THREADS or not group_for(bucket):
        bucket = 0
    group = group_for(bucket)
    if early_stop:
        group = min(group, max(1, 32 // cw_threads))
    if not group:
        group = 1  # does not fit: cuda_bp refuses it by its size
    r = np.arange(Z)
    p_idx = np.zeros((Z, idx_stride), dtype=np.int64)
    if bucket:
        for e in range(E):
            p_idx[:, e] = col[e] * Z + (r + shifts[e]) % Z
    else:
        p_idx = p_idx[:0]

    p_idx = np.ascontiguousarray(p_idx.astype(np.uint16))
    p_idx.setflags(write=False)
    return LayeredPlan(
        bucket=bucket, group=group, cw_threads=cw_threads,
        threads=threads_of(group), idx_stride=idx_stride,
        r_stride=r_stride,
        smem=smem_bytes(Z, mb, nb, E, bucket, group, idx_stride, r_stride,
                        msg_bytes),
        p_idx=p_idx, row_ptr=i32(row_ptr), e_p=i32(col * Z),
        e_shift=i32(shifts))


def gmem_smem_bytes(Z: int, mb: int, nb: int, E: int) -> int:
    """Shared memory of one K2g block: the per-edge offsets and shifts,
    the row pointer, one codeword's P and its two flags; R lies in device
    memory.  The C entry point ldpc_bp_layered_gmem_smem_bytes computes
    the same."""
    return smem_bytes(Z, mb, nb, E, 0, 1, 0, 0, 4)


@dataclasses.dataclass(frozen=True)
class LayeredGmemPlacement:
    """K2g's block and scratch."""

    cw_threads: int  # threads a codeword: one a check up to GMEM_MAX_THREADS
    threads: int     # cw_threads in whole warps
    smem: int        # bytes of shared memory a block (gmem_smem_bytes)
    stride: int      # scratch bytes a codeword: its R


def layered_gmem_placement(Z: int, mb: int, nb: int, E: int,
                           msg_bytes: int = 4) -> LayeredGmemPlacement:
    """K2g's placement, for a code whose layered state exceeds one block's
    shared memory: one codeword a block, its P and bucket 0's per-edge
    tables in shared memory, one thread a check up to GMEM_MAX_THREADS,
    and its R (E * Z messages of `msg_bytes`) edge-major in a scratch of
    ``stride`` bytes a codeword.  Bucket 0's two-pass rows, whatever the
    code's rows: at BG2 r1/5, Z = 384 they ran 1.8x faster than the
    16-slot one-pass rows with their index table in shared memory, and
    the smaller block holds two codewords an SM; one thread a check ran
    1.5x faster than 256 threads (PERF.md, K2g).  Raises where P and the
    tables alone exceed one block's shared memory."""
    smem = gmem_smem_bytes(Z, mb, nb, E)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"the layered decoder's P and tables alone take {smem} B, "
            f"beyond the {SMEM_LIMIT_BYTES} B of shared memory one block "
            f"may use")
    cw_threads = min(Z, GMEM_MAX_THREADS)
    raw = E * Z * msg_bytes
    return LayeredGmemPlacement(
        cw_threads=cw_threads, threads=-(-cw_threads // 32) * 32, smem=smem,
        stride=raw + (-raw) % GMEM_STATE_ALIGN)
