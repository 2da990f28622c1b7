"""Decoder dispatch (port of ``tpu_ldpc/decode/api.py``).

``decode(code, llrs, algo=..., iters=...) -> (bits, ok, iters_used)``.
``impl`` picks the implementation:

- ``'auto'``: the CUDA kernel for CUDA tensors, the plain PyTorch
  version for CPU tensors -- chosen by the tensor's device, never as a
  fallback;
- ``'torch'``: the plain PyTorch version on any device;
- ``'cuda'``: the CUDA kernel; raises for a tensor that is not on the card.

Slice 1 ports flooding min-sum only.  Everything else raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device

_NOT_PORTED_IMPL = {
    "pallas": "the TPU kernel's counterpart is impl='cuda' "
              "(ROADMAP Queue 2 K1)",
    "jnp": "the jnp reference's counterpart is impl='torch' "
           "(ROADMAP Queue 1 item 1)",
    "twophase": "two-phase straggler compaction is ROADMAP Queue 1 item 5",
}


def build_decode_fn(code: LdpcCode, cfg, device):
    """cfg: sim.mc.DecodeCfg (or anything with the same fields).

    Returns fn(llr (batch, n) float32 on `device`) -> (bits, ok, iters_used)
    with early termination on."""
    device = resolve_device(device)
    impl = getattr(cfg, "impl", "auto")
    if getattr(cfg, "quant_bits", None) is not None:
        raise NotImplementedError(
            "quantized decoding (quant_bits) is not ported yet "
            "(ROADMAP Queue 2 K5)"
        )
    if cfg.algo in ("bitflip", "wbf"):
        raise NotImplementedError(
            f"algo={cfg.algo!r} is not ported yet (ROADMAP Queue 1 item 7)"
        )
    if cfg.schedule == "windowed":
        raise NotImplementedError(
            "schedule='windowed' is not ported yet (ROADMAP Queue 1 item 7)"
        )
    if impl in _NOT_PORTED_IMPL:
        raise NotImplementedError(
            f"impl={impl!r} is not available in the port: "
            f"{_NOT_PORTED_IMPL[impl]}"
        )
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA device, got {device}")

    from tpu_ldpc_torch.decode.reference import build_decoder

    # validates algo / schedule (raises NotImplementedError for K2-K4)
    plain = build_decoder(code, cfg.algo, cfg.iters, cfg.alpha, cfg.beta,
                          cfg.schedule, True)

    def decode_fn(llr: torch.Tensor):
        if llr.device.type != device.type:
            raise ValueError(
                f"llr is on {llr.device}, decoder was built for {device}"
            )
        if impl == "torch":
            return plain(llr)
        from tpu_ldpc_torch.decode.cuda_bp import minsum_flood

        return minsum_flood(code, llr, cfg.iters, cfg.alpha, cfg.beta,
                            early_stop=True)

    return decode_fn


def decode(
    code: LdpcCode,
    llrs,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    impl: str = "auto",
    quant_bits: int | None = None,
):
    """Decode (batch, n) LLRs on their own device (NumPy input: the CPU)."""
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    if not isinstance(llrs, torch.Tensor):
        llrs = torch.as_tensor(np.asarray(llrs, dtype=np.float32))
    llrs = llrs.to(torch.float32).contiguous()
    cfg = DecodeCfg(algo=algo, iters=iters, alpha=alpha, beta=beta,
                    schedule=schedule, impl=impl, quant_bits=quant_bits)
    return build_decode_fn(code, cfg, llrs.device)(llrs)
