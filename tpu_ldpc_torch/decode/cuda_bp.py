"""BP decode on the card: the wrappers of the CUDA kernels
``csrc/bp_flood.cu`` and ``csrc/bp_layered.cu`` (port of the flooding and
layered branches of ``tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder``
with its min-sum and exact sum-product CN updates).

One wrapper per (CN update, schedule):

- ``minsum_flood``       K1, flooding min-sum;
- ``minsum_layered``     K2, layered min-sum;
- ``sumproduct_flood``   K3, flooding exact sum-product;
- ``sumproduct_layered`` K3, layered exact sum-product.

Each takes float32 LLRs (batch, n) and returns (bits uint8 (batch, n),
ok bool (batch,), iters_used int32 (batch,)).  For a CPU tensor it runs
the plain PyTorch version (``decode/reference.py``); for a CUDA tensor it
launches its kernel on the current stream or raises -- there is no
fallback.  ``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import to_device
from tpu_ldpc_torch.decode.reference import build_decoder

SMEM_LIMIT_BYTES = 232_448  # 227 KB: the most one Hopper block may use
_ALGO_IDS = {"minsum": 0, "sumproduct": 1}  # ldpc::Algo in bp_common.cuh


def _decode(wrapper, algo: str, schedule: str, code: LdpcCode,
            llr: torch.Tensor, iters: int, alpha: float, beta: float,
            early_stop: bool):
    if llr.device.type == "cpu":
        fn = build_decoder(code, algo, iters, alpha, beta, schedule,
                           early_stop)
        return fn(llr)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != code.n:
        raise ValueError(
            f"llr must be (batch, {code.n}), got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")

    from tpu_ldpc_torch._build import check, load_library

    layered = schedule == "layered"
    lib = load_library("bp_layered" if layered else "bp_flood")
    dc = to_device(code, llr.device)
    smem_fn = (lib.ldpc_bp_layered_smem_bytes if layered
               else lib.ldpc_bp_flood_smem_bytes)
    smem = smem_fn(code.Z, code.nb, dc.E)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{code.name}: {schedule} decoder state {smem} B exceeds the "
            f"{SMEM_LIMIT_BYTES} B of shared memory one block may use"
        )
    batch = llr.shape[0]
    bits = torch.empty((batch, code.n), dtype=torch.uint8, device=llr.device)
    ok = torch.empty((batch,), dtype=torch.bool, device=llr.device)
    iters_used = torch.empty((batch,), dtype=torch.int32, device=llr.device)
    if batch == 0:
        return bits, ok, iters_used
    ptrs = (llr.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            iters_used.data_ptr(), dc.edge_col.data_ptr(),
            dc.edge_shift.data_ptr(), dc.row_ptr.data_ptr())
    tail = (int(iters), float(alpha), float(beta), int(bool(early_stop)))
    with torch.cuda.device(llr.device):  # restores the current device
        stream = torch.cuda.current_stream().cuda_stream
        if layered:
            err = lib.ldpc_bp_layered(
                _ALGO_IDS[algo], *ptrs, batch, code.Z, code.mb, code.nb,
                dc.E, *tail, stream)
        else:
            err = lib.ldpc_bp_flood(
                _ALGO_IDS[algo], *ptrs, dc.col_slots.data_ptr(),
                dc.col_deg.data_ptr(), batch, code.Z, code.mb, code.nb,
                dc.E, int(dc.col_slots.shape[1]), *tail, stream)
    check(lib, err, f"{wrapper.__name__} launch")
    wrapper.launches += 1
    return bits, ok, iters_used


def minsum_flood(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                 alpha: float = 0.75, beta: float = 0.0,
                 early_stop: bool = True):
    """K1: flooding normalized / offset min-sum (csrc/bp_flood.cu)."""
    return _decode(minsum_flood, "minsum", "flooding", code, llr, iters,
                   alpha, beta, early_stop)


def minsum_layered(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                   alpha: float = 0.75, beta: float = 0.0,
                   early_stop: bool = True):
    """K2: layered normalized / offset min-sum (csrc/bp_layered.cu)."""
    return _decode(minsum_layered, "minsum", "layered", code, llr, iters,
                   alpha, beta, early_stop)


def sumproduct_flood(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                     alpha: float = 0.75, beta: float = 0.0,
                     early_stop: bool = True):
    """K3: flooding exact sum-product (csrc/bp_flood.cu); alpha and beta
    are ignored, as in every sum-product decoder of the repo."""
    return _decode(sumproduct_flood, "sumproduct", "flooding", code, llr,
                   iters, alpha, beta, early_stop)


def sumproduct_layered(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                       alpha: float = 0.75, beta: float = 0.0,
                       early_stop: bool = True):
    """K3: layered exact sum-product (csrc/bp_layered.cu); alpha and beta
    are ignored."""
    return _decode(sumproduct_layered, "sumproduct", "layered", code, llr,
                   iters, alpha, beta, early_stop)


WRAPPERS = {
    ("minsum", "flooding"): minsum_flood,
    ("minsum", "layered"): minsum_layered,
    ("sumproduct", "flooding"): sumproduct_flood,
    ("sumproduct", "layered"): sumproduct_layered,
}
for _w in WRAPPERS.values():
    _w.launches = 0
