"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/*.cu

The library lands in ``build/tpu_ldpc_torch/libldpc_kernels_<hash>.so``
at the repository root, named by a hash of the sources and flags, so a
source change rebuilds.  A failed build raises with nvcc's output; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tpu_ldpc_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_log = ""       # nvcc's output (ptxas register / spill report)
build_seconds = 0.0  # 0.0 when the library was already built


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc (CUDA toolkit) not found on PATH or under $CUDA_HOME/bin: the "
        "CUDA kernels of tpu_ldpc_torch cannot be built"
    )


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libldpc_kernels_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_minsum_flood.argtypes = [
        p, p, p, p,          # llr, bits, ok, iters_used
        p, p, p, p, p,       # edge_col, edge_shift, row_ptr, col_slots, col_deg
        i, i, i, i, i, i,    # batch, Z, mb, nb, E, max_col_deg
        i, f, f, i,          # iters, alpha, beta, early_stop
        p,                   # stream
    ]
    lib.ldpc_minsum_flood.restype = ctypes.c_int
    lib.ldpc_minsum_flood_smem_bytes.argtypes = [i, i, i]
    lib.ldpc_minsum_flood_smem_bytes.restype = ctypes.c_size_t
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p


def load_library():
    """The kernels' ctypes library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.ldpc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
