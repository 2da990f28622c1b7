"""Decoder dispatch (port of ``tpu_ldpc/decode/api.py``).

``decode(code, llrs, algo=..., iters=..., schedule=...) -> (bits, ok,
iters_used)``.  algo is 'minsum', 'sumproduct' or 'sumproduct-fast',
schedule 'flooding' or 'layered'; ``quant_bits`` / ``quant_step`` /
``quant_post_bits`` select fixed-point min-sum.  algo 'bitflip' / 'wbf'
runs the hard-decision decoders (``decode/hard.py``), and
schedule='windowed' the windowed SC-LDPC decoder (``decode/windowed.py``,
``window`` block-rows, ``iters`` per slide, ``window_sweep`` 'flooding'
or 'layered'); both are plain PyTorch on any device and take no
``impl``.  Otherwise ``impl`` picks the implementation:

- ``'auto'``: ``build_cuda_decoder`` (decode/cuda_bp.py), in the code's
  own coordinates: the CUDA kernel for CUDA tensors, the plain PyTorch
  version for CPU tensors -- chosen by the tensor's device, never as a
  fallback;
- ``'torch'``: the plain PyTorch version on any device;
- ``'cuda'``: the CUDA kernel; raises for a tensor that is not on the card.

Quantization with ``bitflip`` / ``wbf`` or the windowed schedule raises
ValueError, as does ``window_sweep`` outside the windowed schedule, as in
the JAX package.

Long blocklengths: a flooding decode whose state the flooding kernel
cannot hold in one block's shared memory
(``flood_plan.code_flood_smem_bytes`` above ``SMEM_LIMIT_BYTES``, NR BG1
at Z = 384) runs, without a mesh, the flooding kernel's device-memory
form (``bp_flood_gmem_kernel``, through ``build_cuda_decoder``), bit for
bit with the shared-memory kernel.  Given a mesh (``dist/mesh.py``),
``build_decode_fn`` sends such a float decode with impl='auto' to the
ring decoder (``dist/ring.py``) when the code is banded (``is_banded``)
and the ring can split it over the mesh (``fits_ring``), and to the
row-striped partitioned decoder (``dist/partitioned.py``) otherwise.
The JAX package tries the ring on any code; at one rank the ring takes
every code, so the band test is what keeps a dense base on the
partitioned decoder there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.decode.flood_plan import (
    SMEM_LIMIT_BYTES, code_flood_smem_bytes)
from tpu_ldpc_torch.spans import span

_NOT_PORTED_IMPL = {
    "pallas": "the TPU kernel's counterpart is impl='cuda'",
    "jnp": "the jnp reference's counterpart is impl='torch'",
    "twophase": "the single-pass early-terminated decoder, impl='auto', "
                "gives the same bits, ok and iters_used",
}


def build_decode_fn(code: LdpcCode, cfg, device, mesh=None, *,
                    early_stop: bool = True):
    """cfg: sim.mc.DecodeCfg (or anything with the same fields).

    Returns fn(llr (batch, n) float32 on `device`) -> (bits, ok, iters_used)
    with early termination on; early_stop=False runs every iteration
    (the throughput benchmark's fixed-work point).  Only the flooding and
    layered BP decoders of one device take it.  mesh: a
    ``dist.mesh.Mesh``; a code the flooding kernel cannot hold in shared
    memory then decodes on the ring or the partitioned decoder (module
    docstring), which every rank of the mesh calls with the same LLRs;
    without a mesh it takes the flooding kernel's device-memory form."""
    device = resolve_device(device)
    impl = getattr(cfg, "impl", "auto")
    if not early_stop and (cfg.algo in ("bitflip", "wbf")
                           or cfg.schedule == "windowed"
                           or mesh is not None):
        raise ValueError("early_stop=False applies only to the flooding / "
                         "layered BP decoders of one device")
    # the one set of quantization keywords every decoder below takes
    quant = dict(quant_bits=getattr(cfg, "quant_bits", None),
                 quant_step=getattr(cfg, "quant_step", 0.5),
                 quant_post_bits=getattr(cfg, "quant_post_bits", None))
    # quantization is plumbed through the soft BP paths only: reject it
    # rather than report float results labeled as quantized
    if quant["quant_bits"] is not None and (cfg.algo in ("bitflip", "wbf")
                                            or cfg.schedule == "windowed"):
        raise ValueError(
            "quant_bits is not supported for hard-decision algos or the "
            "windowed schedule; it is only plumbed through the soft "
            "flooding/layered BP paths")
    # window_sweep means something only inside the windowed schedule:
    # reject it rather than run plain flooding labeled as layered
    if (getattr(cfg, "window_sweep", "flooding") != "flooding"
            and cfg.schedule != "windowed"):
        raise ValueError("window_sweep applies only to schedule='windowed'")
    if cfg.algo in ("bitflip", "wbf"):
        from tpu_ldpc_torch.decode.hard import build_hard_decoder

        run = build_hard_decoder(code, cfg.algo, cfg.iters, device=device)
    elif cfg.schedule == "windowed":
        # cfg.iters counts iterations per window slide here
        from tpu_ldpc_torch.decode.windowed import build_windowed_decoder

        run = build_windowed_decoder(
            code, window=cfg.window, iters_per_window=cfg.iters,
            algo=cfg.algo, alpha=cfg.alpha, beta=cfg.beta,
            sweep=getattr(cfg, "window_sweep", "flooding"), device=device)
    elif (mesh is not None and impl == "auto"
          and quant["quant_bits"] is None and cfg.schedule == "flooding"
          and code_flood_smem_bytes(code) > SMEM_LIMIT_BYTES):
        from tpu_ldpc_torch.dist.ring import (
            build_ring_decoder, fits_ring, is_banded)

        if is_banded(code) and fits_ring(code, mesh.size):
            return build_ring_decoder(
                code, mesh, algo=cfg.algo, iters=cfg.iters, alpha=cfg.alpha,
                beta=cfg.beta)
        from tpu_ldpc_torch.dist.partitioned import build_partitioned_decoder

        return build_partitioned_decoder(
            code, mesh, algo=cfg.algo, iters=cfg.iters, alpha=cfg.alpha,
            beta=cfg.beta)
    else:
        run = _build_bp(code, cfg, device, impl, quant, early_stop)

    def decode_fn(llr: torch.Tensor):
        if llr.device.type != device.type:
            raise ValueError(
                f"llr is on {llr.device}, decoder was built for {device}"
            )
        with span("ldpc.decode"):
            return run(llr)

    return decode_fn


def _build_bp(code: LdpcCode, cfg, device, impl: str, quant: dict,
              early_stop: bool):
    """The soft BP decoder of `cfg.impl` (flooding or layered)."""
    if impl in _NOT_PORTED_IMPL:
        raise NotImplementedError(
            f"impl={impl!r} is not available in the port: "
            f"{_NOT_PORTED_IMPL[impl]}"
        )
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA device, got {device}")

    if impl == "torch":
        from tpu_ldpc_torch.decode.reference import build_decoder

        return build_decoder(code, cfg.algo, cfg.iters, cfg.alpha,
                             cfg.beta, cfg.schedule, early_stop, **quant)
    # the code's own coordinates, unlike the JAX package's TPU path
    # (build_pallas_decoder's default): the outputs are the same, and on
    # the H100 shift normalization measured slower (PERF.md, K9)
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

    return build_cuda_decoder(code, cfg.algo, cfg.iters, cfg.alpha,
                              cfg.beta, cfg.schedule, early_stop,
                              normalize=False, **quant)


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
    quant_step: float = 0.5,
    quant_post_bits: int | None = None,
    window: int = 8,
    window_sweep: str = "flooding",
    device=None,
):
    """Decode (batch, n) LLRs.

    device=None: a tensor stays on its own device; NumPy input goes to
    the card ('cuda', which raises without one) -- pass device='cpu' for
    the plain PyTorch path.  A given device moves the LLRs there."""
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    if device is None:
        device = llrs.device if isinstance(llrs, torch.Tensor) else "cuda"
    device = resolve_device(device)
    if not isinstance(llrs, torch.Tensor):
        llrs = torch.as_tensor(np.asarray(llrs, dtype=np.float32))
    llrs = llrs.to(device=device, dtype=torch.float32).contiguous()
    cfg = DecodeCfg(algo=algo, iters=iters, alpha=alpha, beta=beta,
                    schedule=schedule, impl=impl, quant_bits=quant_bits,
                    quant_step=quant_step, quant_post_bits=quant_post_bits,
                    window=window, window_sweep=window_sweep)
    return build_decode_fn(code, cfg, device)(llrs)
