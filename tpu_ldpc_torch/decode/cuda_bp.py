"""BP decode on the card: ``build_cuda_decoder``, the counterpart of the
JAX package's ``tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder``, and
the launch counts of its CUDA kernels (``csrc/bp_flood.cu``,
``csrc/bp_layered.cu``, ``csrc/bp_compressed.cu``).

The builder takes the JAX builder's decoding arguments, defaults and
refusals (``reference.check_modes``) and returns fn(llr): float32 LLRs
(batch, n) -> (bits uint8 (batch, n), ok bool (batch,), iters_used int32
(batch,)).  For a CPU tensor fn runs the plain PyTorch version
(``decode/reference.py::build_decoder``, same arguments); for a CUDA
tensor it launches its kernel on the current stream or raises -- there is
no fallback.  The TPU-only knobs (batch_tile, exit_block, unroll,
interpret, dtype and the VMEM budget) have no counterpart.

Flooding decoders take K1g (``bp_flood_gmem_kernel``) where the code's
state exceeds one block's shared memory (``ldpc_bp_flood_smem_bytes``
above ``flood_plan.SMEM_LIMIT_BYTES``, NR BG1 at Z = 384): every mode
above, bit for bit with the shared-memory kernel, R (and L and P where
``flood_plan.gmem_placement`` cannot keep them in shared memory) in a
scratch buffer of ``GmemPlacement.stride`` bytes a codeword that each call
allocates (``torch.empty``, inside the span ``ldpc.decode.gmem``).
Layered decoders likewise take K2g (``bp_layered_gmem_kernel``) where
``ldpc_bp_layered_smem_bytes`` exceeds the limit (NR BG2 r1/5 and BG1
r1/2 at Z = 384): every layered mode, bit for bit with K2, P and the
tables in shared memory and R in a scratch of
``LayeredGmemPlacement.stride`` bytes a codeword
(``layered_plan.layered_gmem_placement``), allocated in the same span.
The compressed schedule raises there, naming the flooding one.

Each launch adds one to ``LAUNCHES[fn.kernel]``, a launch in normalized
coordinates also to ``LAUNCHES[fn.kernel + '_normalized']`` (shift
normalization is a mode of the same kernel body), a launch of K1g or K2g
also to ``LAUNCHES[fn.kernel + '_gmem']``, one of K1g with L and P in shared
memory also to ``LAUNCHES[fn.kernel + '_gmem_smem']``, and a flooding
launch whose rows all take bucket 0's one-gather form
(``flood_plan.one_gather``: K1 bucket 0 or K1g, rows of at most 32 slots,
any CN update but exact sum-product) also to
``LAUNCHES[fn.kernel + '_one_gather']``.  Kernel names:

- ``minsum_flood`` / ``minsum_layered``: K1 / K2 (K1g / K2g above the
  limit), min-sum;
- ``sumproduct_flood`` / ``sumproduct_layered``: K3, exact sum-product;
- ``spfast_flood`` / ``spfast_layered``: K4, sumproduct-fast;
- ``minsum_quant_flood`` / ``minsum_quant_layered``: K5, fixed-point;
- ``minsum_compressed_flood``: K6, compressed row state;
- ``<one of the six float kernels>_bf16``: K7, bf16 message storage;
- ``minsum_rescaled_flood``: K8, rescaled min-sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.decode.flood_plan import (
    SMEM_LIMIT_BYTES, compressed_plan, flood_plan, gmem_placement,
    one_gather)
from tpu_ldpc_torch.decode.layered_plan import (
    layered_gmem_placement, layered_plan)
from tpu_ldpc_torch.decode.normalize import coordinates
from tpu_ldpc_torch.decode.reference import (
    build_decoder, is_bf16, quant_params)
from tpu_ldpc_torch.spans import span, spanned

# ldpc::Algo in bp_common.cuh
_ALGO_IDS = {"minsum": 0, "sumproduct": 1, "sumproduct-fast": 2}
_ALGO_NAMES = {"minsum": "minsum", "sumproduct": "sumproduct",
               "sumproduct-fast": "spfast"}


def kernel_name(algo: str, schedule: str, *, quantized: bool = False,
                bf16: bool = False, rescaled: bool = False,
                compressed: bool = False) -> str:
    """The launch-count name of a kernel (module docstring)."""
    if compressed:
        return "minsum_compressed_flood"
    if rescaled:
        return "minsum_rescaled_flood"
    sched = "flood" if schedule == "flooding" else "layered"
    quant = "_quant" if quantized else ""
    return (f"{_ALGO_NAMES[algo]}{quant}_{sched}"
            f"{'_bf16' if bf16 else ''}")


def _all_names():
    names = []
    for sched in ("flooding", "layered"):
        for algo in _ALGO_IDS:
            names += [kernel_name(algo, sched),
                      kernel_name(algo, sched, bf16=True)]
        names.append(kernel_name("minsum", sched, quantized=True))
    names.append(kernel_name("minsum", "flooding", rescaled=True))
    normalized = [f"{name}_normalized" for name in names]
    flood = [f"{name}{suffix}" for name in names if "_flood" in name
             for suffix in ("_gmem", "_gmem_smem", "_one_gather")]
    layered = [f"{name}_gmem" for name in names if "_layered" in name]
    return names + [kernel_name("minsum", "flooding", compressed=True)] \
        + normalized + flood + layered


# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = dict.fromkeys(_all_names(), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=64)
@spanned("ldpc.build")
def build_cuda_decoder(
    code: LdpcCode,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    early_stop: bool = True,
    *,
    normalize: bool = True,
    rescaled: bool = False,
    msg_dtype=None,
    compressed: bool = False,
    quant_bits: int | None = None,
    quant_step: float = 0.5,
    quant_post_bits: int | None = None,
):
    """fn(llr) -> (bits, ok, iters_used) (module docstring).

    normalize: run in shift-normalized coordinates (decode/normalize.py;
      outputs unchanged; ignored with compressed).  rescaled: rescaled
      min-sum (golden's contract).  msg_dtype=torch.bfloat16: R stored in
      bf16.  compressed: per-check compressed row state in place of R.
    quant_bits / quant_step / quant_post_bits: fixed-point min-sum; post
      bits default to quant_bits + 2 (resolved by ``quant_params``)."""
    # the plain version checks every argument combination (check_modes)
    plain = build_decoder(code, algo, iters, alpha, beta, schedule,
                          early_stop, quant_bits, quant_step,
                          quant_post_bits, normalize=normalize,
                          rescaled=rescaled, msg_dtype=msg_dtype,
                          compressed=compressed)
    bf16 = is_bf16(msg_dtype)
    normalized = normalize and not compressed
    shifts, col_off = coordinates(code, normalized)
    flooding = schedule == "flooding" and not compressed
    name = kernel_name(algo, schedule, quantized=quant_bits is not None,
                       bf16=bf16, rescaled=rescaled, compressed=compressed)
    counters = (name, f"{name}_normalized") if normalized else (name,)
    # (quantized, step, kmax, lim_msg, lim_post)
    qargs = (0, 0.0, 0.0, 0.0, 0.0)
    if quant_bits is not None:
        qargs = (1, *quant_params(quant_bits, quant_step, quant_post_bits))
    inv_alpha = float(np.float32(1.0) / np.float32(alpha))
    # device -> (column offsets as int32, the plan's tables)
    tables = {}

    def launch(llr: torch.Tensor):
        from tpu_ldpc_torch._build import check, load_library

        lib = load_library("bp_compressed" if compressed else
                           "bp_flood" if flooding else "bp_layered")
        E = code.layout.E
        if compressed:
            plan = compressed_plan(code)
            smem = lib.ldpc_bp_compressed_smem_bytes(
                code.Z, code.mb, code.nb, E, int(plan.one_check))
        elif flooding:
            plan = flood_plan(code, shifts)
            smem = lib.ldpc_bp_flood_smem_bytes(code.Z, code.mb, code.nb,
                                                E, plan.bucket, bf16)
        else:
            plan = layered_plan(code, shifts, 2 if bf16 else 4,
                                bool(early_stop))
            smem = lib.ldpc_bp_layered_smem_bytes(
                code.Z, code.mb, code.nb, E, plan.bucket, plan.group,
                plan.idx_stride, plan.r_stride, bf16)
        # above the limit the flooding and layered decoders keep their
        # state in device memory (K1g, K2g); compressed state has no such
        # form
        gmem = smem > SMEM_LIMIT_BYTES
        shared_lp = False
        if gmem and compressed:
            raise ValueError(
                f"{code.name}: {name} decoder state {smem} B exceeds the "
                f"{SMEM_LIMIT_BYTES} B of shared memory one block may use; "
                f"schedule='flooding' without compressed state takes such "
                f"a code, its state in device memory")
        if llr.device not in tables:
            tables[llr.device] = (
                torch.tensor(col_off, dtype=torch.int32, device=llr.device),
                # uint16 index tables go as int16: the kernel reads the bits
                [torch.from_numpy(np.array(x).view(
                    np.int16 if x.dtype == np.uint16 else x.dtype)).to(
                        llr.device) for x in plan.tables().values()])
        coff, ptabs = tables[llr.device]
        tab_ptrs = [t.data_ptr() or None for t in ptabs]
        coff_ptr = coff.data_ptr() if any(col_off) else None  # NULL: plain
        batch = llr.shape[0]
        bits = torch.empty((batch, code.n), dtype=torch.uint8,
                           device=llr.device)
        ok = torch.empty((batch,), dtype=torch.bool, device=llr.device)
        iu = torch.empty((batch,), dtype=torch.int32, device=llr.device)
        if batch == 0:
            return bits, ok, iu
        outs = (llr.data_ptr(), bits.data_ptr(), ok.data_ptr(),
                iu.data_ptr())
        with torch.cuda.device(llr.device):  # restores the current device
            stream = torch.cuda.current_stream().cuda_stream
            if compressed:
                err = lib.ldpc_bp_compressed(
                    *outs, *tab_ptrs, batch, code.Z, code.mb, code.nb, E,
                    code.layout.max_row_deg, int(plan.one_check),
                    plan.threads, int(iters), float(alpha), float(beta),
                    int(bool(early_stop)), stream)
            elif gmem and not flooding:
                with span("ldpc.decode.gmem"):
                    place = layered_gmem_placement(
                        code.Z, code.mb, code.nb, E, 2 if bf16 else 4)
                    state = torch.empty(batch * place.stride,
                                        dtype=torch.uint8, device=llr.device)
                    # K2g reads the plan's row pointer and per-edge tables,
                    # not its p_idx
                    err = lib.ldpc_bp_layered_gmem(
                        _ALGO_IDS[algo], *outs, *tab_ptrs[1:], coff_ptr,
                        batch, code.Z, code.mb, code.nb, E, place.cw_threads,
                        place.threads, int(iters), float(alpha),
                        float(beta), int(bool(early_stop)), int(bf16),
                        *qargs, state.data_ptr(), place.stride, stream)
            elif gmem:
                with span("ldpc.decode.gmem"):
                    place = gmem_placement(code.Z, code.mb, code.nb, E,
                                           bf16, SMEM_LIMIT_BYTES)
                    shared_lp = place.shared_lp
                    state = torch.empty(batch * place.stride,
                                        dtype=torch.uint8, device=llr.device)
                    err = lib.ldpc_bp_flood_gmem(
                        _ALGO_IDS[algo], *outs, *tab_ptrs, coff_ptr,
                        batch, code.Z, code.mb, code.nb, E, int(iters),
                        float(alpha), float(beta), int(bool(early_stop)),
                        int(bf16), int(bool(rescaled)), inv_alpha, *qargs,
                        int(shared_lp), place.threads, state.data_ptr(),
                        place.stride, stream)
            elif flooding:
                err = lib.ldpc_bp_flood(
                    _ALGO_IDS[algo], *outs, *tab_ptrs, coff_ptr,
                    batch, code.Z, code.mb, code.nb, E, plan.bucket,
                    plan.threads, int(iters), float(alpha), float(beta),
                    int(bool(early_stop)), int(bf16), int(bool(rescaled)),
                    inv_alpha, *qargs, stream)
            else:
                err = lib.ldpc_bp_layered(
                    _ALGO_IDS[algo], *outs, *tab_ptrs, coff_ptr, batch,
                    code.Z, code.mb, code.nb, E, plan.bucket, plan.group,
                    plan.cw_threads, plan.threads, plan.idx_stride,
                    plan.r_stride, int(iters), float(alpha), float(beta),
                    int(bool(early_stop)), int(bf16), *qargs, stream)
        check(lib, err, f"{name} launch")
        route_counters = ((f"{name}_gmem",) if gmem else ()) + (
            (f"{name}_gmem_smem",) if shared_lp else ()) + (
            (f"{name}_one_gather",)
            if flooding and one_gather(plan, algo, gmem) else ())
        for counter in counters + route_counters:
            LAUNCHES[counter] += 1
        return bits, ok, iu

    def decode_fn(llr: torch.Tensor):
        if llr.device.type == "cpu":
            return plain(llr)
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
        return launch(llr)

    decode_fn.kernel = name
    return decode_fn
