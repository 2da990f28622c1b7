"""BP decode on the card: the wrappers of the CUDA kernels
``csrc/bp_flood.cu`` and ``csrc/bp_layered.cu`` (port of the flooding and
layered branches of ``tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder``
with its min-sum, exact sum-product and sumproduct-fast CN updates and its
fixed-point quantized mode).

One wrapper per (CN update, schedule, quantized):

- ``minsum_flood``         K1, flooding min-sum;
- ``minsum_layered``       K2, layered min-sum;
- ``sumproduct_flood``     K3, flooding exact sum-product;
- ``sumproduct_layered``   K3, layered exact sum-product;
- ``spfast_flood``         K4, flooding sumproduct-fast;
- ``spfast_layered``       K4, layered sumproduct-fast;
- ``minsum_quant_flood``   K5, flooding fixed-point min-sum;
- ``minsum_quant_layered`` K5, layered fixed-point min-sum.

Each takes float32 LLRs (batch, n) and returns (bits uint8 (batch, n),
ok bool (batch,), iters_used int32 (batch,)).  For a CPU tensor it runs
the plain PyTorch version (``decode/reference.py``); for a CUDA tensor it
launches its kernel on the current stream or raises -- there is no
fallback.  ``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

import functools

import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import to_device
from tpu_ldpc_torch.decode.reference import build_decoder, quant_params

SMEM_LIMIT_BYTES = 232_448  # 227 KB: the most one Hopper block may use
# ldpc::Algo in bp_common.cuh
_ALGO_IDS = {"minsum": 0, "sumproduct": 1, "sumproduct-fast": 2}


def _decode(wrapper, algo: str, schedule: str, code: LdpcCode,
            llr: torch.Tensor, iters: int, alpha: float, beta: float,
            early_stop: bool, quant=None):
    """quant: None, or (quant_bits, quant_step, quant_post_bits)."""
    if llr.device.type == "cpu":
        fn = build_decoder(code, algo, iters, alpha, beta, schedule,
                           early_stop, *(quant or ()))
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
    # (quantized, step, kmax, lim_msg, lim_post), checked on the host; the
    # C entry point refuses quantization with a CN other than min-sum
    qargs = (0, 0.0, 0.0, 0.0, 0.0)
    if quant is not None:
        qargs = (1, *quant_params(*quant))

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
    tail = (int(iters), float(alpha), float(beta), int(bool(early_stop)),
            *qargs)
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


def spfast_flood(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                 alpha: float = 0.75, beta: float = 0.0,
                 early_stop: bool = True):
    """K4: flooding sumproduct-fast (csrc/bp_flood.cu); alpha and beta
    are ignored."""
    return _decode(spfast_flood, "sumproduct-fast", "flooding", code, llr,
                   iters, alpha, beta, early_stop)


def spfast_layered(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                   alpha: float = 0.75, beta: float = 0.0,
                   early_stop: bool = True):
    """K4: layered sumproduct-fast (csrc/bp_layered.cu); alpha and beta
    are ignored."""
    return _decode(spfast_layered, "sumproduct-fast", "layered", code, llr,
                   iters, alpha, beta, early_stop)


def minsum_quant_flood(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                       alpha: float = 0.75, beta: float = 0.0,
                       early_stop: bool = True, *, quant_bits: int,
                       quant_step: float = 0.5,
                       quant_post_bits: int | None = None):
    """K5: flooding fixed-point min-sum (csrc/bp_flood.cu); post bits
    default to quant_bits + 2."""
    return _decode(minsum_quant_flood, "minsum", "flooding", code, llr,
                   iters, alpha, beta, early_stop,
                   (quant_bits, quant_step, quant_post_bits))


def minsum_quant_layered(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                         alpha: float = 0.75, beta: float = 0.0,
                         early_stop: bool = True, *, quant_bits: int,
                         quant_step: float = 0.5,
                         quant_post_bits: int | None = None):
    """K5: layered fixed-point min-sum (csrc/bp_layered.cu); post bits
    default to quant_bits + 2."""
    return _decode(minsum_quant_layered, "minsum", "layered", code, llr,
                   iters, alpha, beta, early_stop,
                   (quant_bits, quant_step, quant_post_bits))


# (algo, schedule, quantized) -> wrapper; a quantized wrapper takes the
# keywords quant_bits, quant_step and quant_post_bits
WRAPPERS = {
    ("minsum", "flooding", False): minsum_flood,
    ("minsum", "layered", False): minsum_layered,
    ("sumproduct", "flooding", False): sumproduct_flood,
    ("sumproduct", "layered", False): sumproduct_layered,
    ("sumproduct-fast", "flooding", False): spfast_flood,
    ("sumproduct-fast", "layered", False): spfast_layered,
    ("minsum", "flooding", True): minsum_quant_flood,
    ("minsum", "layered", True): minsum_quant_layered,
}
for _w in WRAPPERS.values():
    _w.launches = 0


def wrapper_for(algo: str, schedule: str, quant_bits: int | None = None,
                quant_step: float = 0.5, quant_post_bits: int | None = None):
    """The wrapper of (algo, schedule, quantized) as fn(code, llr, iters,
    alpha, beta, early_stop), with the quantization keywords bound."""
    wrapper = WRAPPERS.get((algo, schedule, quant_bits is not None))
    if wrapper is None:
        raise ValueError(f"no decoder for algo={algo!r}, schedule="
                         f"{schedule!r}, quant_bits={quant_bits!r}")
    if quant_bits is None:
        return wrapper
    return functools.partial(wrapper, quant_bits=quant_bits,
                             quant_step=quant_step,
                             quant_post_bits=quant_post_bits)
