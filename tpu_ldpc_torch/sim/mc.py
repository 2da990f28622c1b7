"""Monte-Carlo BER/FER harness (port of ``tpu_ldpc/sim/mc.py``).

One batch is PRNG -> encode -> BPSK/AWGN -> decode -> six counters, all on
the device; a host loop stops each Eb/N0 point on a frame-error target.
The counters of ``steps_per_call`` batches are summed on the device and
the host syncs once per call.

PRNG rule: every batch draws from its own ``torch.Generator`` on the
device, seeded from (seed, snr_idx, batch_ctr) through
``np.random.SeedSequence``.  So resumed or regrouped runs draw the same
numbers per batch.  The streams are PyTorch's (Philox on CUDA,
Mersenne Twister on the CPU), not JAX's Threefry: counters agree with
the JAX harness statistically, not draw for draw.  The draw is split
from the count (``BatchFn.draw`` / ``BatchFn.batch_counters``) so tests
can feed both packages the same inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Sequence

import numpy as np
import torch

from tpu_ldpc.codes.code import LdpcCode
from tpu_ldpc_torch.channel.awgn import llrs_from_noise
from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.decode.api import build_decode_fn
from tpu_ldpc_torch.encode.encoder import select_encoder


@dataclasses.dataclass(frozen=True)
class DecodeCfg:
    algo: str = "minsum"
    iters: int = 50
    alpha: float = 0.75
    beta: float = 0.0
    schedule: str = "flooding"  # only 'flooding' is ported
    impl: str = "auto"          # 'auto' | 'torch' | 'cuda'
    # fixed-point emulation mode: not ported (ROADMAP Queue 2 K5), raises
    quant_bits: int | None = None


COUNTER_FIELDS = (
    "frames",
    "bit_errors",      # over info bits
    "frame_errors",    # any info bit wrong
    "detected",        # decoder reported not-ok (syndrome unsatisfied)
    "undetected",      # syndrome ok but wrong codeword
    "iter_sum",        # sum of iters_used
)


@dataclasses.dataclass
class SnrResult:
    ebn0_db: float
    frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    detected: int = 0
    undetected: int = 0
    iter_sum: int = 0
    wall_s: float = 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        # info-bit error rate; bits filled in by the harness
        return self.bit_errors / max(self.bits, 1)

    bits: int = 0

    @property
    def mean_iters(self) -> float:
        return self.iter_sum / max(self.frames, 1)


def _log_step(path: str, res: SnrResult, t0: float, k: int) -> None:
    elapsed = time.perf_counter() - t0
    rec = {
        "ebn0_db": res.ebn0_db,
        "frames": res.frames,
        "bit_errors": res.bit_errors,
        "frame_errors": res.frame_errors,
        "mean_iters": res.mean_iters,
        "wall_s": round(elapsed, 4),
        "info_bits_per_s": round(res.frames * k / max(elapsed, 1e-9), 1),
    }
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def batch_generator(seed: int, snr_idx: int, batch_ctr: int,
                    device) -> torch.Generator:
    """The generator of one batch, seeded from (seed, snr_idx, batch_ctr)."""
    state = np.random.SeedSequence([seed, snr_idx, batch_ctr]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0] >> np.uint64(1)))
    return gen


class BatchFn:
    """One Monte-Carlo batch: draw (u, noise), then count.

    ``k`` is the info bits counted per frame (the true dimension for
    rank-deficient codes, which take the pivot encoder)."""

    def __init__(self, code: LdpcCode, cfg: DecodeCfg, batch: int, device):
        self.device = resolve_device(device)
        self.batch, self.n = batch, code.n
        self.encode_fn, self.k, info_cols = select_encoder(
            code, device=self.device)
        self.decode_fn = build_decode_fn(code, cfg, self.device)
        self.info_cols = (None if info_cols is None
                          else torch.as_tensor(info_cols).to(self.device))
        # true information rate (k may exceed the design dimension)
        self.rate = self.k / code.n

    def draw(self, generator: torch.Generator):
        u = torch.randint(0, 2, (self.batch, self.k), generator=generator,
                          device=self.device, dtype=torch.uint8)
        noise = torch.randn((self.batch, self.n), generator=generator,
                            device=self.device, dtype=torch.float32)
        return u, noise

    def batch_counters(self, u: torch.Tensor, noise: torch.Tensor,
                       ebn0_db: float) -> torch.Tensor:
        """(6,) int64 counters (COUNTER_FIELDS order) on the device."""
        c = self.encode_fn(u)
        llr = llrs_from_noise(c, noise, ebn0_db, self.rate)
        bits, ok, iters_used = self.decode_fn(llr)
        info = (bits[:, :self.k] if self.info_cols is None
                else bits[:, self.info_cols])
        wrong = info != u
        frame_wrong = wrong.any(dim=1)
        return torch.stack([
            torch.full((), u.shape[0], dtype=torch.int64, device=u.device),
            wrong.sum(),
            frame_wrong.sum(),
            (~ok).sum(),
            (ok & frame_wrong).sum(),
            iters_used.sum(dtype=torch.int64),
        ])

    def __call__(self, generator: torch.Generator, ebn0_db: float):
        return self.batch_counters(*self.draw(generator), ebn0_db)


def build_batch_fn(code: LdpcCode, cfg: DecodeCfg, batch: int, *,
                   device) -> BatchFn:
    return BatchFn(code, cfg, batch, device)


@functools.lru_cache(maxsize=64)
def _build_mc_step(code, cfg, batch, steps_per_call, device):
    one_batch = BatchFn(code, cfg, batch, device)

    def step(seed: int, snr_idx: int, ebn0_db: float, ctr0: int):
        acc = torch.zeros(6, dtype=torch.int64, device=device)
        for t in range(steps_per_call):
            gen = batch_generator(seed, snr_idx, ctr0 + t, device)
            acc += one_batch(gen, ebn0_db)
        return acc

    step.k = one_batch.k
    return step


def build_mc_step(code: LdpcCode, cfg: DecodeCfg, batch: int,
                  steps_per_call: int = 1, *, device):
    """MC step: (seed, snr_idx, ebn0_db, ctr0) -> (6,) int64 counters on
    the device, summed over batches ctr0 .. ctr0 + steps_per_call - 1.
    Counter totals are identical for any steps_per_call grouping."""
    return _build_mc_step(code, cfg, batch, steps_per_call,
                          resolve_device(device))


def default_steps_per_call(device: torch.device) -> int:
    """Batches per host sync: amortize round trips on the card."""
    return 8 if device.type == "cuda" else 1


def run_ber(
    code: LdpcCode,
    ebn0_grid: Sequence[float],
    cfg: DecodeCfg = DecodeCfg(),
    batch: int = 256,
    target_frame_errors: int = 100,
    max_frames: int = 1_000_000,
    seed: int = 0,
    progress: bool = False,
    state=None,
    steps_per_call: int | None = None,
    step_log: str | None = None,
    *,
    device,
) -> list[SnrResult]:
    """Frame-error-targeted Eb/N0 sweep on one device.

    device='cuda' raises when no card is present; it never runs on the
    CPU instead.  step_log: path for per-call JSONL records (snr,
    cumulative frames / errors, mean iters, wall time, info bits/s)."""
    device = resolve_device(device)
    if steps_per_call is None:
        steps_per_call = default_steps_per_call(device)
    step = build_mc_step(code, cfg, batch, steps_per_call, device=device)
    results = []
    for snr_idx, ebn0 in enumerate(ebn0_grid):
        res = SnrResult(ebn0_db=float(ebn0))
        batch_ctr = 0
        if state is not None:
            saved = state.load_point(snr_idx)
            if saved is not None:
                res, batch_ctr = saved
        t0 = time.perf_counter()
        while res.frame_errors < target_frame_errors and res.frames < max_frames:
            counters = step(seed, snr_idx, float(ebn0), batch_ctr).tolist()
            for name, v in zip(COUNTER_FIELDS, counters):
                setattr(res, name, getattr(res, name) + int(v))
            batch_ctr += steps_per_call
            if state is not None:
                state.save_point(snr_idx, res, batch_ctr)
            if step_log is not None:
                _log_step(step_log, res, t0, step.k)
        res.wall_s += time.perf_counter() - t0
        res.bits = res.frames * step.k
        results.append(res)
        if progress:
            print(
                f"Eb/N0 {ebn0:5.2f} dB: frames={res.frames} "
                f"FER={res.fer:.3e} BER={res.ber:.3e} "
                f"mean_iters={res.mean_iters:.1f}"
            )
    return results
