"""Native host helper (the port's copy of ``tpu_ldpc/_native``): C++ via
ctypes for the host hot paths of code construction -- cycle counting for
girth-driven shift selection and annealing, and bit-packed GF(2)
elimination for rank checks and the minimum-distance search.

``native.cpp`` is built with g++ at first use (``_build.py``,
``build_host_library``) into ``build/tpu_ldpc_torch/``.  A failed build
raises with g++'s output; nothing falls back to NumPy.  The plain
versions stay beside it as what the tests hold it against: the
pure-Python counters of ``codes/base_graphs.py`` (``_count_4cycles_py``,
``_count_6cycles_py``, ``_ace6_cost_py``, ``_ace8_cost_py``,
``_count_8cycles_raw_py``) and the NumPy ``codes/gf2.py``.

The JAX package's copy also holds ``ldpc_minsum_decode``, an OpenMP CPU
min-sum decoder; it is left out here: the port decodes with
``decode(device='cpu')`` (the plain PyTorch decoder) and, on the card,
with the CUDA kernels (K1).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native.cpp")


@functools.cache
def lib() -> ctypes.CDLL:
    """The helper's ctypes library, built at first use."""
    from tpu_ldpc_torch._build import load_host_library

    so = load_host_library(_SRC)
    i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    ip = ctypes.c_int
    for fn in ("qc_count_4cycles", "qc_count_6cycles",
               "qc_count_8cycles_raw"):
        getattr(so, fn).argtypes = [i64p, ip, ip, ip]
        getattr(so, fn).restype = ctypes.c_longlong
    for fn in ("qc_ace6_cost", "qc_ace8_cost"):
        getattr(so, fn).argtypes = [i64p, ip, ip, ip, i64p]
        getattr(so, fn).restype = ctypes.c_double
    so.gf2_rank.argtypes = [i8p, ip, ip]
    so.gf2_rank.restype = ip
    so.gf2_row_reduce.argtypes = [i8p, ip, ip, i8p]
    so.gf2_row_reduce.restype = ip
    so.gf2_inv.argtypes = [i8p, ip, i8p]
    so.gf2_inv.restype = ip
    so.gf2_parity_map.argtypes = [i8p, ip, ip, i8p]
    so.gf2_parity_map.restype = ip
    return so


def _base(B: np.ndarray) -> np.ndarray:
    B = np.ascontiguousarray(B, dtype=np.int64)
    if B.ndim != 2:
        raise ValueError(f"base matrix must be 2-D, got shape {B.shape}")
    return B


def _colw(B: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray((B >= 0).sum(axis=0), dtype=np.int64)


def _bits(M: np.ndarray) -> np.ndarray:
    M = np.ascontiguousarray(np.asarray(M) % 2, dtype=np.uint8)
    if M.ndim != 2:
        raise ValueError(f"GF(2) matrix must be 2-D, got shape {M.shape}")
    return M


def count_4cycles(B: np.ndarray, Z: int) -> int:
    B = _base(B)
    return int(lib().qc_count_4cycles(B, B.shape[0], B.shape[1], Z))


def count_6cycles(B: np.ndarray, Z: int) -> int:
    B = _base(B)
    return int(lib().qc_count_6cycles(B, B.shape[0], B.shape[1], Z))


def ace6_cost(B: np.ndarray, Z: int) -> float:
    B = _base(B)
    return float(lib().qc_ace6_cost(B, B.shape[0], B.shape[1], Z, _colw(B)))


def count_8cycles_raw(B: np.ndarray, Z: int) -> int:
    B = _base(B)
    return int(lib().qc_count_8cycles_raw(B, B.shape[0], B.shape[1], Z))


def ace8_cost(B: np.ndarray, Z: int) -> float:
    B = _base(B)
    return float(lib().qc_ace8_cost(B, B.shape[0], B.shape[1], Z, _colw(B)))


def gf2_rank(M: np.ndarray) -> int:
    M = _bits(M)
    return int(lib().gf2_rank(M, M.shape[0], M.shape[1]))


def gf2_row_reduce(M: np.ndarray):
    """(rref, pivot_cols): bit-packed RREF, the semantics of
    ``codes/gf2.py::gf2_row_reduce`` (leftmost pivots, eliminated above and
    below).  Row r's pivot is its first set column."""
    M = _bits(M)
    out = np.zeros_like(M)
    rank = int(lib().gf2_row_reduce(M, M.shape[0], M.shape[1], out))
    pivots = out[:rank].argmax(axis=1).tolist() if rank else []
    return out, pivots


def gf2_inv(M: np.ndarray) -> np.ndarray:
    M = _bits(M)
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError(f"gf2_inv needs a square matrix, got {M.shape}")
    out = np.zeros((n, n), dtype=np.uint8)
    if lib().gf2_inv(M, n, out) != 0:
        raise ValueError("matrix is singular over GF(2)")
    return out


def parity_map(H_dense: np.ndarray) -> np.ndarray:
    """M (m x k) with p = M u over GF(2), for dense H = [A | B]."""
    H = _bits(H_dense)
    m, n = H.shape
    out = np.zeros((m, n - m), dtype=np.uint8)
    rc = lib().gf2_parity_map(H, m, n, out)
    if rc != 0:
        raise ValueError(f"parity part not invertible (rc={rc})")
    return out
