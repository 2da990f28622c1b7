"""Two-phase early-termination decode with straggler compaction (port of
``tpu_ldpc/decode/twophase.py``).

  1. ET-decode the full batch with a short iteration budget K: most
     codewords converge.
  2. Gather the codewords still failing into a compacted batch of
     `budget` lanes (a stable argsort of ok: failing lanes first, in lane
     order), ET-decode it from the channel LLRs with the full budget
     `iters`, and scatter the results back.

BP is deterministic, so re-decoding a codeword from scratch replays its
trajectory: phase 2's (bits, ok, iters_used) for a straggler are what
the single-pass ET decoder gives, and the two-phase output is
bit-identical to it.  Converged lanes that pad the budget decode to the
same converged result.  When more than `budget` codewords fail phase 1,
the whole batch is decoded again with the full budget instead.

On the card every codeword's block exits on its own, so the single-pass
kernel already pays only for the iterations each codeword needs; the
TPU, whose tile exits when all 128 lanes converge, gained far more from
this scheme.  It is ported as a capability of the JAX package.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder


@functools.lru_cache(maxsize=32)
def build_twophase_decoder(
    code: LdpcCode,
    iters: int = 50,
    phase1_iters: int = 16,
    budget: int = 512,
    report_fallback: bool = False,
    warn_on_fallback: bool = False,
    phase1_alpha: float | None = None,
    algo: str = "minsum",
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    **decoder_kw,
):
    """Two-phase ET decoder: llr (batch, n) float32 -> (bits, ok,
    iters_used), bit-identical to the single-pass ET decoder with `iters`
    iterations, on the llr's own device: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors.

    phase1_iters: full-batch iteration budget K, clamped to `iters` (a
      larger K would let phase 1 report lanes that converge after
      `iters`, which single-pass ET reports as failed).
    budget: compacted phase-2 batch size.
    report_fallback: return a 4th output, n_unconv (int), the count of
      lanes unconverged after phase 1; n_unconv > budget means the
      full-batch fallback ran.
    warn_on_fallback: warn once, the first time a call overflows the
      budget.
    phase1_alpha: run phase 1 with another normalization constant; the
      output is then NOT bit-identical to any single-pass decoder.
    decoder_kw: the mode keywords of ``build_cuda_decoder`` (normalize,
      rescaled, msg_dtype, compressed, quant_bits / quant_step /
      quant_post_bits), the same in both phases, as the JAX package's
      decoder_kw; still bit-identical to single-pass ET under them.

    Whether phase 2 is compacted or runs on the full batch is decided on
    the host: n_unconv is read once per call (one device-to-host copy and
    synchronisation), where the JAX package branches on the device with
    lax.cond.
    """
    phase1_iters = min(int(phase1_iters), int(iters))
    budget = int(budget)
    alpha1 = alpha if phase1_alpha is None else float(phase1_alpha)
    f1 = build_cuda_decoder(code, algo, phase1_iters, alpha1, beta,
                            schedule, True, **decoder_kw)
    f2 = build_cuda_decoder(code, algo, int(iters), alpha, beta, schedule,
                            True, **decoder_kw)
    warned = {"fired": False}

    def decode_fn(llr: torch.Tensor):
        bits, ok, iu = f1(llr)
        n_unconv = int((~ok).sum())  # host read: picks the branch
        if n_unconv <= budget:
            # unconverged lanes first (stable: preserves lane order)
            order = torch.argsort(ok.to(torch.int32), stable=True)
            idx = order[:budget]
            b2, ok2, iu2 = f2(llr[idx])
            bits[idx], ok[idx], iu[idx] = b2, ok2, iu2
        else:
            bits, ok, iu = f2(llr)
            if warn_on_fallback and not warned["fired"]:
                warned["fired"] = True
                warnings.warn(
                    f"twophase: {n_unconv} unconverged lanes overflowed "
                    f"the compaction budget {budget}; this call decoded "
                    "the full batch again (correct, slower).  Raise "
                    "compact_budget / phase1_iters for this operating "
                    "point (tune with decode.twophase.tune_phase1_iters).",
                    stacklevel=2,
                )
        if report_fallback:
            return bits, ok, iu, n_unconv
        return bits, ok, iu

    return decode_fn


def tune_phase1_iters(code: LdpcCode, ebn0_db: float, batch: int = 4096,
                      iters: int = 50, seed: int = 0, margin: float = 2.0,
                      *, device, **decoder_kw):
    """Pick (phase1_iters, budget) from the measured iteration
    distribution at an operating point.

    Decodes `batch` random codewords at `ebn0_db` (the LLRs of
    ``benchcore.make_timer(code, batch, ebn0_db, n_buffers=1, seed=seed)``,
    on `device`) once with the single-pass ET decoder
    ``build_cuda_decoder(code, iters=iters, early_stop=True,
    **decoder_kw)`` -- decoder_kw: algo, alpha, beta, schedule and the
    mode keywords (quant_*, msg_dtype, rescaled, compressed, normalize),
    as the JAX tuner passes them to build_pallas_decoder -- builds the
    straggler curve survivors[K] (lanes needing more than K iterations),
    sizes the phase-2 budget at each K as `margin` x the stragglers
    rounded up to 128 lanes, and picks the K minimizing the work model
    K*batch + iters*budget(K).  The model counts iterations, not time:
    measure the tuned K and its neighbours on the card.  Returns
    (phase1_iters, budget, stats_dict).
    """
    from tpu_ldpc_torch.benchcore import make_timer

    llr = make_timer(code, batch, ebn0_db, device=device, n_buffers=1,
                     seed=seed).llrs[0]
    dec = build_cuda_decoder(code, iters=int(iters), early_stop=True,
                             **decoder_kw)
    _, ok, iu = (x.cpu().numpy() for x in dec(llr))
    # lanes that never converge report iu == iters and are stragglers
    # at every K < iters; the budget must cover them
    iu_eff = np.where(ok, iu, iters)
    hist = np.bincount(iu_eff, minlength=iters + 1)
    survivors = batch - np.cumsum(hist)  # survivors[K] = #lanes with iu > K

    def budget_at(K):
        return min(batch, max(128, int(np.ceil(
            margin * max(1, survivors[K]) / 128)) * 128))

    costs = {K: K * batch + iters * budget_at(K)
             for K in range(1, iters + 1)}
    K = min(costs, key=costs.get)
    budget = budget_at(K)
    stats = {"mean_iters": float(iu_eff.mean()),
             "frac_unconverged": float((~ok).mean()),
             "K": int(K), "n_stragglers": int(survivors[K]),
             "budget": int(budget)}
    return int(K), int(budget), stats
