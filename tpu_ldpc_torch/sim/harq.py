"""Incremental-redundancy HARQ over the NR-like rate-compatible family
(port of ``tpu_ldpc/sim/harq.py``; ``codes/nrlike.py``).

Encode once at the lowest rate (the full mother), transmit a high-rate
prefix, and on decode failure send more parity block-columns: each
retransmission reveals more of the same mother codeword, so the receiver
re-decodes a longer truncation with the LLRs gathered so far.  Nesting
makes this sound: extension parities depend only on earlier columns, so
the first (kb + m) block-columns of a mother codeword form a codeword of
the m-row truncation for every m.

Every stage decodes the full batch, but a lane's delivered stage is its
first success; `bits_sent` counts, per lane, the increments up to that
stage (all stages for lanes never delivered).

Delivery is gated by an outer CRC (``codes/crc.py``) by default: a lane
ACKs at its first stage whose decoded info block passes the CRC, and a
pass on a wrong payload is a false ACK (``false_acks``).  The genie
verdict (decoded == sent) is kept as ``fer_after_genie``; ``crc=None``
terminates on the genie alone.  ``avg_info_rate`` counts payload bits
(k - crc width) per transmitted bit.

The payload, its CRC and the noise are drawn with NumPy's
``default_rng(seed)`` in the JAX package's order, so both packages see
the same frames draw for draw; each stage decodes on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpu_ldpc_torch.codes.nrlike import (
    KB,
    KB2,
    M_MOTHER,
    M_MOTHER2,
    make_nrlike_base_graph,
)


@dataclasses.dataclass
class HarqResult:
    ebn0_db: float
    stages: list          # per stage: dict(m, n_tx_cum, fer_after, ...)
    frames: int
    delivered: int        # frames ACKed (CRC pass; genie if crc=None)
    avg_bits_sent: float  # mean transmitted bits per frame (per-lane HARQ)
    avg_info_rate: float  # payload bits / avg_bits_sent
    crc: str | None = None      # CRC gating delivery (None = genie)
    k_payload: int = 0          # info bits per frame excl. CRC
    false_acks: int = 0         # CRC passed on a wrong payload

    @property
    def residual_fer(self) -> float:
        return 1.0 - self.delivered / self.frames

    @property
    def false_ack_rate(self) -> float:
        """P(undetected error | ACK): the rate the CRC width governs."""
        return self.false_acks / max(self.delivered, 1)


def run_irharq(
    Z: int = 64,
    stage_m: Sequence[int] = (7, 10, 13, 24),
    ebn0_db: float = 3.0,
    batch: int = 256,
    iters: int = 50,
    algo: str = "minsum",
    alpha: float = 0.75,
    seed: int = 0,
    impl: str = "auto",
    bg: int = 1,
    crc: str | None = "crc24",
    device="cuda",
) -> HarqResult:
    """Simulate per-lane IR-HARQ: first transmission at stage_m[0]'s
    rate, one parity increment per later stage.

    The mother codeword is encoded once (the port's encoder on the full
    mother); noise is drawn once for every position and revealed stage
    by stage.  Eb/N0 references the first transmission's rate.
    impl: the decoder of every stage (``decode.api``): 'auto' is the
    CUDA kernel on the card and the plain version on the CPU, 'torch'
    the plain version on any device.  device='cuda' raises without a
    card; pass device='cpu' explicitly.
    """
    from tpu_ldpc_torch.channel.awgn import noise_sigma2
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.codes_device import resolve_device
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.encode.encoder import select_encoder
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    device = resolve_device(device)
    kb = KB if bg == 1 else KB2
    m_mother = M_MOTHER if bg == 1 else M_MOTHER2
    stage_m = sorted(set(int(m) for m in stage_m))
    if stage_m[0] < 4 or stage_m[-1] > m_mother:
        raise ValueError(f"stage_m must lie in [4, {m_mother}]")
    mother = LdpcCode(f"nr{bg}_m{m_mother}_z{Z}",
                      make_nrlike_base_graph(Z, m=m_mother, kb=kb), Z)
    k = mother.k
    rng = np.random.default_rng(seed)
    if crc is not None:
        from tpu_ldpc_torch.codes.crc import attach, check, get_spec

        spec = get_spec(crc)
        kp = k - spec.width
        if kp <= 0:
            raise ValueError(f"{spec.name} width >= info length {k}")
        u = attach(rng.integers(0, 2, (batch, kp)).astype(np.uint8),
                   spec)                      # [payload | crc(payload)]
    else:
        kp = k
        u = rng.integers(0, 2, (batch, k)).astype(np.uint8)
    encode_fn, k_enc, info_cols = select_encoder(mother, device=device)
    if k_enc != k or info_cols is not None:
        raise ValueError(f"{mother.name}: not systematic in the first k "
                         "positions")
    # one mother codeword a lane
    c = encode_fn(torch.from_numpy(u).to(device)).cpu().numpy()
    x = 1.0 - 2.0 * c.astype(np.float64)

    # Eb/N0 -> sigma referenced to the first transmission's true info
    # rate (payload bits per transmitted bit: the CRC is overhead)
    r1 = kp / ((kb + stage_m[0] - 2) * Z)
    sigma2 = noise_sigma2(ebn0_db, r1)
    llr_full = ((2.0 / sigma2) * (
        x + np.sqrt(sigma2) * rng.normal(size=x.shape))
    ).astype(np.float32)
    # the two high-degree systematic blocks are never transmitted
    llr_full[:, : 2 * Z] = 0.0

    delivered_at = np.full(batch, -1, dtype=np.int64)  # stage index
    false_ack = np.zeros(batch, dtype=bool)   # ACKed with wrong payload
    cfg = DecodeCfg(algo=algo, iters=iters, alpha=alpha, impl=impl)
    stages = []
    for si, m in enumerate(stage_m):
        n_m = (kb + m) * Z
        code_m = LdpcCode(f"nr{bg}_m{m}_z{Z}",
                          make_nrlike_base_graph(Z, m=m, kb=kb), Z)
        # the observations so far: every transmitted position of this
        # truncation; the punctured pair stays erased (LLR 0)
        llr_m = torch.from_numpy(np.ascontiguousarray(llr_full[:, :n_m]))
        bits, ok, _ = build_decode_fn(code_m, cfg, device)(
            llr_m.to(device))
        bits, ok = bits.cpu().numpy(), ok.cpu().numpy()
        # a lane ACKs at its first stage whose decoded info block passes
        # the CRC; the genie verdict is kept as a cross-check column
        correct = (bits[:, :kp] == u[:, :kp]).all(axis=1)
        acked = check(bits[:, :k], spec) if crc is not None else correct
        newly = acked & (delivered_at < 0)
        delivered_at[newly] = si
        false_ack[newly & ~correct] = True
        n_tx_cum = n_m - 2 * Z
        stages.append({
            "m": m, "n_tx_cum": n_tx_cum,
            "rate_cum": kp / n_tx_cum,
            "fer_after": float(1.0 - (delivered_at >= 0).mean()),
            "fer_after_genie": float(
                1.0 - ((delivered_at >= 0) & ~false_ack).mean()),
            "ok_frac": float(ok.mean()),
        })
    # per-lane bits on air: increments up to the delivering stage
    # (lanes never delivered paid for every stage)
    tx_bits_at = np.asarray([s["n_tx_cum"] for s in stages])
    per_lane = np.where(delivered_at >= 0,
                        tx_bits_at[np.maximum(delivered_at, 0)],
                        tx_bits_at[-1])
    avg_bits = float(per_lane.mean())
    return HarqResult(
        ebn0_db=ebn0_db, stages=stages, frames=batch,
        delivered=int((delivered_at >= 0).sum()),
        avg_bits_sent=avg_bits, avg_info_rate=kp / avg_bits,
        crc=None if crc is None else spec.name,
        k_payload=kp, false_acks=int(false_ack.sum()),
    )
