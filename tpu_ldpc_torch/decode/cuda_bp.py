"""Flooding min-sum decode on the card: the wrapper of the CUDA kernel
``csrc/minsum_flood.cu`` (port of the flooding branch of
``tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder``).

``minsum_flood`` takes float32 LLRs (batch, n).  For a CPU tensor it runs
the plain PyTorch version (``decode/reference.py``); for a CUDA tensor it
launches the kernel on the current stream or raises -- there is no
fallback.  ``minsum_flood.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import to_device
from tpu_ldpc_torch.decode.reference import build_decoder

SMEM_LIMIT_BYTES = 232_448  # 227 KB: the most one Hopper block may use


def minsum_flood(code: LdpcCode, llr: torch.Tensor, iters: int = 50,
                 alpha: float = 0.75, beta: float = 0.0,
                 early_stop: bool = True):
    """-> (bits uint8 (batch, n), ok bool (batch,), iters_used int32 (batch,))."""
    if llr.device.type == "cpu":
        fn = build_decoder(code, "minsum", iters, alpha, beta, "flooding",
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

    lib = load_library()
    dc = to_device(code, llr.device)
    smem = lib.ldpc_minsum_flood_smem_bytes(code.Z, code.nb, dc.E)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{code.name}: decoder state {smem} B exceeds the "
            f"{SMEM_LIMIT_BYTES} B of shared memory one block may use"
        )
    batch = llr.shape[0]
    bits = torch.empty((batch, code.n), dtype=torch.uint8, device=llr.device)
    ok = torch.empty((batch,), dtype=torch.bool, device=llr.device)
    iters_used = torch.empty((batch,), dtype=torch.int32, device=llr.device)
    if batch == 0:
        return bits, ok, iters_used
    with torch.cuda.device(llr.device):  # restores the current device
        err = lib.ldpc_minsum_flood(
            llr.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            iters_used.data_ptr(), dc.edge_col.data_ptr(),
            dc.edge_shift.data_ptr(), dc.row_ptr.data_ptr(),
            dc.col_slots.data_ptr(), dc.col_deg.data_ptr(),
            batch, code.Z, code.mb, code.nb, dc.E,
            int(dc.col_slots.shape[1]), int(iters), float(alpha),
            float(beta), int(bool(early_stop)),
            torch.cuda.current_stream().cuda_stream,
        )
    check(lib, err, "minsum_flood launch")
    minsum_flood.launches += 1
    return bits, ok, iters_used


minsum_flood.launches = 0
