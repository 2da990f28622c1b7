"""Build the CUDA kernels and the host helper at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  The first
``load_library`` call starts one ``nvcc`` for every source whose library
is missing, all at once, and waits for them all:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

A library lands in ``build/tpu_ldpc_torch/lib<name>_<hash>.so`` at the
repository root, named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so a change rebuilds; nvcc's output (the
ptxas report) beside it in ``<lib>.log``.  A failed build raises with
nvcc's output; there is no fallback.

The host helper (``_native/native.cpp``: cycle counters and bit-packed
GF(2) algebra for code construction) takes the host-compiler route,
``build_host_library``:

    g++ -O3 -shared -fPIC -std=c++17 -o <lib> _native/native.cpp

into the same directory, named ``lib<stem>_<hash>.so`` by a hash of the
source and the flags.  Several processes may build it at once (pytest
workers): each writes its own temporary name and renames it into place.
A failed build raises with g++'s output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from tpu_ldpc_torch.spans import span

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tpu_ldpc_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per loaded source: nvcc's output (ptxas report), from this build or the
# log kept beside an existing library
build_log: dict[str, str] = {}


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


def sources() -> dict[str, str]:
    """{library name: path} of every csrc/*.cu."""
    srcs = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC_DIR}")
    return {os.path.basename(p)[:-3]: p for p in srcs}


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = [sources()[name]]
    deps += sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cuh")))
    for path in deps:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _build_missing() -> None:
    """Start one nvcc per missing library, all at once; wait for all
    (inside the span ``ldpc.build``)."""
    todo = {name: library_path(name) for name in sources()}
    todo = {name: out for name, out in todo.items() if not os.path.exists(out)}
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _find_nvcc()
    with span("ldpc.build"):
        procs = {}
        for name, out in todo.items():
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, sources()[name]]
            procs[name] = (cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (cmd, tmp, out, proc) in procs.items():
            build_log[name] = proc.communicate()[0]
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                failed.append(f"nvcc failed (rc={proc.returncode}): "
                              f"{' '.join(cmd)}\n{build_log[name]}")
            else:
                with open(f"{out}.log", "w") as f:
                    f.write(build_log[name])
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if hasattr(lib, "ldpc_bp_flood"):
        lib.ldpc_bp_flood.argtypes = [
            i,                   # algo
            p, p, p, p,          # llr, bits, ok, iters_used
            p, p, p, p,          # vn_info, cn_p, cn_r, cn_deg
            p, p, p, p,          # row_ptr, e_p, e_r, e_shift
            p,                   # col_off
            i, i, i, i, i,       # batch, Z, mb, nb, E
            i, i,                # bucket, threads
            i, f, f, i,          # iters, alpha, beta, early_stop
            i, i, f,             # msg_bf16, rescaled, inv_alpha
            i, f, f, f, f,       # quantized, step, kmax, lim_msg, lim_post
            p,                   # stream
        ]
        lib.ldpc_bp_flood.restype = ctypes.c_int
        lib.ldpc_bp_flood_smem_bytes.argtypes = [i, i, i, i, i, i]
        lib.ldpc_bp_flood_smem_bytes.restype = ctypes.c_size_t
        lib.ldpc_bp_flood_gmem.argtypes = [
            i,                   # algo
            p, p, p, p,          # llr, bits, ok, iters_used
            p, p, p, p,          # vn_info, cn_p, cn_r, cn_deg
            p, p, p, p,          # row_ptr, e_p, e_r, e_shift
            p,                   # col_off
            i, i, i, i, i,       # batch, Z, mb, nb, E
            i, f, f, i,          # iters, alpha, beta, early_stop
            i, i, f,             # msg_bf16, rescaled, inv_alpha
            i, f, f, f, f,       # quantized, step, kmax, lim_msg, lim_post
            i, i,                # shared_lp, threads
            p, ctypes.c_size_t,  # state, bytes a codeword
            p,                   # stream
        ]
        lib.ldpc_bp_flood_gmem.restype = ctypes.c_int
        lib.ldpc_bp_flood_gmem_smem_bytes.argtypes = [i] * 5
        lib.ldpc_bp_flood_gmem_smem_bytes.restype = ctypes.c_size_t
    if hasattr(lib, "ldpc_bp_layered"):
        lib.ldpc_bp_layered.argtypes = [
            i,                   # algo
            p, p, p, p,          # llr, bits, ok, iters_used
            p, p, p, p,          # p_idx, row_ptr, e_p, e_shift
            p,                   # col_off
            i, i, i, i, i,       # batch, Z, mb, nb, E
            i, i, i, i,          # bucket, group, cw_threads, threads
            i, i,                # idx_stride, r_stride
            i, f, f, i,          # iters, alpha, beta, early_stop
            i,                   # msg_bf16
            i, f, f, f, f,       # quantized, step, kmax, lim_msg, lim_post
            p,                   # stream
        ]
        lib.ldpc_bp_layered.restype = ctypes.c_int
        lib.ldpc_bp_layered_smem_bytes.argtypes = [i] * 9
        lib.ldpc_bp_layered_smem_bytes.restype = ctypes.c_size_t
    if hasattr(lib, "ldpc_bp_compressed"):
        lib.ldpc_bp_compressed.argtypes = [
            p, p, p, p,          # llr, bits, ok, iters_used
            p, p, p, p,          # cn_p, cn_deg, vn_info, vn_check
            i, i, i, i, i,       # batch, Z, mb, nb, E
            i, i, i, i,          # max_row_deg, one_check, threads, iters
            f, f, i,             # alpha, beta, early_stop
            p,                   # stream
        ]
        lib.ldpc_bp_compressed.restype = ctypes.c_int
        lib.ldpc_bp_compressed_smem_bytes.argtypes = [i, i, i, i, i]
        lib.ldpc_bp_compressed_smem_bytes.restype = ctypes.c_size_t
    if hasattr(lib, "ldpc_mc_encode_llr"):
        lib.ldpc_mc_encode_llr.argtypes = [
            p, p, p,             # u, noise, llr
            p, p, p,             # table, pos, active_u
            p, p,                # tx_mask, known_llr
            i, i, i, f, f,       # batch, k, n, sigma, scale
            p,                   # stream
        ]
        lib.ldpc_mc_encode_llr.restype = ctypes.c_int
        lib.ldpc_mc_count.argtypes = [
            p, p, p, p,          # bits, u, passed, iters
            p, p,                # info_cols, active_u
            i, i, i, i,          # batch, n, k, kp
            p, p,                # acc, stream
        ]
        lib.ldpc_mc_count.restype = ctypes.c_int
    lib.ldpc_cuda_error_string.argtypes = [i]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p


def load_library(name: str):
    """The ctypes library of csrc/<name>.cu; the first call builds every
    missing library in parallel."""
    with _lock:
        if name not in _libs:
            if name not in sources():
                raise ValueError(f"no CUDA source csrc/{name}.cu")
            path = library_path(name)
            if not os.path.exists(path):
                _build_missing()
            lib = ctypes.CDLL(path)
            _declare(lib)
            if name not in build_log and os.path.exists(f"{path}.log"):
                with open(f"{path}.log") as f:
                    build_log[name] = f.read()
            _libs[name] = lib
        return _libs[name]


def load_all() -> dict[str, ctypes.CDLL]:
    """Every kernel library (built in parallel where missing)."""
    return {name: load_library(name) for name in sources()}


def check(lib, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.ldpc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the host helper of tpu_ldpc_torch "
            "(_native/native.cpp) cannot be built")
    return gxx


def host_library_path(src: str, out_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(out_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_host_library(src: str, out_dir: str = BUILD_DIR) -> str:
    """Path of the g++-built shared library of the C++ source `src`,
    building it first when it is missing."""
    out = host_library_path(src, out_dir)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_find_gxx(), *GXX_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"g++ failed (rc={proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load_host_library(src: str) -> ctypes.CDLL:
    """The ctypes library of the C++ source `src` (built at first use)."""
    with _lock:
        if src not in _libs:
            _libs[src] = ctypes.CDLL(build_host_library(src))
        return _libs[src]
