"""Operating-point search: Eb/N0 at a target FER (port of
``tpu_ldpc/sim/search.py``).

Bisection on Eb/N0, relying on FER being monotone non-increasing in
Eb/N0 (up to Monte-Carlo noise, which the frame-error targets bound).
Every probe is one frame-error-targeted ``run_ber`` point on `device`
(over the ranks of `mesh` when one is given);
the decoder is built once and reused by every probe (``run_ber`` caches
its MC step by configuration).
"""

from __future__ import annotations

import dataclasses

from tpu_ldpc_torch.sim.mc import DecodeCfg, SnrResult, run_ber
from tpu_ldpc_torch.spans import spanned


@dataclasses.dataclass
class FerSearchResult:
    ebn0_db: float            # midpoint of the final bracket
    bracket: tuple            # (lo, hi) dB with fer(lo) >= target >= fer(hi)
    target_fer: float
    probes: list              # SnrResult per probed point, in probe order
    converged: bool           # False if target lies outside [lo, hi]


@spanned("ldpc.search")
def find_ebn0_at_fer(
    code,
    target_fer: float,
    cfg: DecodeCfg = DecodeCfg(),
    lo: float = 0.0,
    hi: float = 6.0,
    tol_db: float = 0.1,
    target_frame_errors: int = 50,
    max_frames: int | None = None,
    batch: int = 256,
    seed: int = 0,
    mesh=None,
    adapt=None,
    progress: bool = False,
    *,
    device,
) -> FerSearchResult:
    """Bisect for the Eb/N0 where FER crosses `target_fer`.

    Each probe is a frame-error-targeted run_ber point capped at
    `max_frames` (default 4 * target_frame_errors / target_fer: enough
    frames to resolve target_fer with ~`target_frame_errors` errors).
    Returns a FerSearchResult whose bracket satisfies fer(lo) >= target
    >= fer(hi); `converged` is False when the target lies outside the
    initial range (the nearest endpoint is returned).  adapt: rate
    adaptation of every probe (``channel.adapt.RateAdapt``), Eb/N0
    referenced to its effective rate.  mesh: probes run over its ranks
    (``run_ber``'s mesh).
    """
    if not 0.0 < target_fer < 1.0:
        raise ValueError(f"target_fer must be in (0, 1), got {target_fer}")
    if max_frames is None:
        max_frames = int(4 * target_frame_errors / target_fer)
    probes: list[SnrResult] = []

    @spanned("ldpc.search.probe")
    def fer_at(ebn0: float) -> float:
        res = run_ber(
            code, [ebn0], cfg=cfg, batch=batch,
            target_frame_errors=target_frame_errors,
            max_frames=max_frames, seed=seed, mesh=mesh, adapt=adapt,
            device=device,
        )[0]
        probes.append(res)
        if progress:
            print(f"probe {ebn0:6.3f} dB: FER={res.fer:.3e} "
                  f"({res.frames} frames)")
        return res.fer

    f_lo = fer_at(lo)
    if f_lo < target_fer:  # already below target at the low end
        return FerSearchResult(lo, (lo, lo), target_fer, probes, False)
    f_hi = fer_at(hi)
    if f_hi > target_fer:  # range never reaches the target
        return FerSearchResult(hi, (hi, hi), target_fer, probes, False)

    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        if fer_at(mid) >= target_fer:
            lo = mid
        else:
            hi = mid
    return FerSearchResult(
        0.5 * (lo + hi), (lo, hi), target_fer, probes, True
    )
