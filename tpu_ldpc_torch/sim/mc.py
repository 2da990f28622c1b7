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

Rate adaptation (``channel/adapt.py::RateAdapt``) and an outer CRC
(``codes/crc.py``) follow the JAX harness: shortened info bits are zeros
and are not counted, punctured positions get LLR +0.0 and shortened ones
+SHORT_LLR, Eb/N0 is referenced to k_eff / n_tx; with a CRC the info
block is [payload | crc(payload)], errors count over the payload, and
detected / undetected mean CRC failed / CRC passed on a wrong payload.
Without either, a batch draws u (batch, k) and then the noise from its
generator: the regroup and resume identities rest on that order.

On the card a batch is five launches: the two draws, ``mc_encode_llr``
(encoder and channel), the decode and ``mc_count`` (``sim/mc_batch.py``,
``csrc/mc_batch.cu``), which adds the counters into the step's
accumulator.  On the CPU it runs the PyTorch ops below, the kernels'
plain version.  Every encoder and mode takes the same two kernels.

A test-only fault-injection hook (``_FAULT_HOOK``, or ``fault_hook=`` of
``BatchFn``) corrupts the decoder's outputs so that tests can check that
the counters catch a faulty decode.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Sequence

import numpy as np
import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.channel.adapt import adapted_llrs_from_noise
from tpu_ldpc_torch.channel.awgn import llrs_from_noise
from tpu_ldpc_torch.codes.crc import (
    get_spec, make_crc_attacher, make_crc_checker)
from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.decode.api import build_decode_fn
from tpu_ldpc_torch.encode.encoder import select_encoder
from tpu_ldpc_torch.sim.mc_batch import BatchKernels
from tpu_ldpc_torch.spans import span, spanned


@dataclasses.dataclass(frozen=True)
class DecodeCfg:
    algo: str = "minsum"
    iters: int = 50
    alpha: float = 0.75
    beta: float = 0.0
    schedule: str = "flooding"  # 'flooding' | 'layered' | 'windowed'
    impl: str = "auto"          # 'auto' | 'torch' | 'cuda'
    # schedule='windowed' only (SC-LDPC chains, decode/windowed.py):
    # window width in block-rows; iters then counts iterations PER
    # WINDOW SLIDE, not in all.  window_sweep picks the schedule inside
    # the window ('flooding' | 'layered': the layered sweep rides the
    # slide direction and needs fewer iterations per position)
    window: int = 8
    window_sweep: str = "flooding"
    # fixed-point emulation mode (min-sum only): message width in bits,
    # LSB step (a power of two) and APP width (None: quant_bits + 2)
    quant_bits: int | None = None
    quant_step: float = 0.5
    quant_post_bits: int | None = None


COUNTER_FIELDS = (
    "frames",
    "bit_errors",      # over info bits (payload bits when CRC-gated)
    "frame_errors",    # any info bit wrong
    "detected",        # decoder reported not-ok (syndrome unsatisfied);
    #                    CRC-gated runs: outer CRC failed
    "undetected",      # syndrome ok but wrong codeword; CRC-gated runs:
    #                    CRC passed on a wrong payload (false ACK)
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
    with span("ldpc.mc.seed"):
        state = np.random.SeedSequence(
            [seed, snr_idx, batch_ctr]).generate_state(1, np.uint64)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state[0] >> np.uint64(1)))
        return gen


# test-only fault-injection hook: called as
# hook(generator, bits, ok, iters_used) -> (bits, ok, iters_used) right
# after the decode.  `generator` is the batch's own (None when counting
# given inputs), drawn from only after `draw`, so the batch's u and noise
# do not change.  Read when a BatchFn is built: clear _build_mc_step's and
# dist.mesh.build_sharded_mc_step's caches after changing it.
_FAULT_HOOK = None


class BatchFn:
    """One Monte-Carlo batch: draw (u, noise), then count.

    ``k`` is the effective info bits credited per frame: the true
    dimension for rank-deficient codes (which take the pivot encoder),
    less the shortened bits of `adapt` and the check bits of `crc`.

    adapt: ``channel.adapt.RateAdapt`` or None.  crc: a ``codes/crc.py``
    name or CrcSpec, or None; with a CRC, `draw` attaches it to a random
    payload.  A CRC together with shortening raises ValueError (the CRC
    would span frozen bits); puncturing composes.  fault_hook: see
    ``_FAULT_HOOK`` (None takes the module's)."""

    def __init__(self, code: LdpcCode, cfg: DecodeCfg, batch: int, device,
                 adapt=None, crc=None, fault_hook=None):
        self.device = resolve_device(device)
        self.fault_hook = (_FAULT_HOOK if fault_hook is None
                           else fault_hook)
        self.batch, self.n = batch, code.n
        self.encode_fn, k, info_cols = select_encoder(
            code, device=self.device)
        self.decode_fn = build_decode_fn(code, cfg, self.device)
        self.info_cols = (None if info_cols is None
                          else torch.as_tensor(info_cols).to(self.device))
        self.k_info = self.kp = k  # info length, payload length
        self.crc_attach = self.crc_ok = None
        if crc is not None:
            spec = get_spec(crc)
            self.kp = k - spec.width
            if self.kp <= 0:
                raise ValueError(
                    f"{spec.name} width {spec.width} >= info length {k}")
            if adapt is not None and not adapt.masks(
                    code.n, k, info_cols)[2].all():
                raise ValueError("crc + shortening unsupported: the CRC "
                                 "would span frozen info bits")
            self.crc_attach = make_crc_attacher(self.kp, spec,
                                                device=self.device)
            self.crc_ok = make_crc_checker(k, spec, device=self.device)
        self.tx_mask = self.known_llr = self.active_u = None
        if adapt is not None:
            k_eff, n_tx = adapt.dims(code.n, k)
            tx, known, active = (torch.as_tensor(a).to(self.device)
                                 for a in adapt.masks(code.n, k, info_cols))
            self.tx_mask, self.known_llr, self.active_u = tx, known, active
        else:
            # true information rate (k may exceed the design dimension)
            k_eff, n_tx = k, code.n
        k_eff -= k - self.kp  # CRC bits are overhead, not information
        self.k = k_eff
        self.rate = k_eff / n_tx
        # on the card two kernels around the decode, whatever the encoder,
        # adaptation or CRC; on the CPU (None) the torch ops
        self.kernels = (BatchKernels.of(self) if self.device.type == "cuda"
                        else None)

    @spanned("ldpc.mc.draw")
    def draw(self, generator: torch.Generator):
        if self.crc_attach is not None:
            u = self.crc_attach(torch.randint(
                0, 2, (self.batch, self.kp), generator=generator,
                device=self.device, dtype=torch.uint8))
        else:
            u = torch.randint(0, 2, (self.batch, self.k_info),
                              generator=generator, device=self.device,
                              dtype=torch.uint8)
        noise = torch.randn((self.batch, self.n), generator=generator,
                            device=self.device, dtype=torch.float32)
        return u, noise

    def batch_counters(self, u: torch.Tensor, noise: torch.Tensor,
                       ebn0_db: float, generator=None,
                       out: torch.Tensor | None = None) -> torch.Tensor:
        """(6,) int64 counters (COUNTER_FIELDS order) on the device;
        `generator` goes to the fault hook alone.  With `out` (int64 (6,)
        on the device) the counters are added into it and it is
        returned."""
        if self.kernels is None:
            u, llr = self.plain_llrs(u, noise, ebn0_db)
        else:
            with span("ldpc.mc.encode"):  # the encoder and the channel
                llr = self.kernels.encode_llr(u, noise, ebn0_db, self.rate)
        bits, ok, iters_used = self.decode_fn(llr)
        if self.fault_hook is not None:
            bits, ok, iters_used = self.fault_hook(generator, bits, ok,
                                                   iters_used)
        with span("ldpc.mc.count"):
            if self.kernels is None:
                counters = self.plain_counters(u, bits, ok, iters_used)
                if out is None:
                    return counters
                out += counters
                return out
            passed = ok
            if self.crc_ok is not None:  # the CRC's check: torch ops
                passed = self.crc_ok(self._info(bits))
            if out is None:
                out = torch.zeros(6, dtype=torch.int64, device=u.device)
            return self.kernels.count(bits, u, passed, iters_used, out)

    def _info(self, bits: torch.Tensor) -> torch.Tensor:
        return (bits[:, :self.k_info] if self.info_cols is None
                else bits[:, self.info_cols])

    def plain_llrs(self, u: torch.Tensor, noise: torch.Tensor,
                   ebn0_db: float):
        """Kernel A's plain version: (u with its shortened bits zeroed,
        the LLRs (batch, n) float32)."""
        with span("ldpc.mc.encode"):
            if self.active_u is not None:
                u = u * self.active_u  # shortened info bits are zeros
            c = self.encode_fn(u)
        with span("ldpc.mc.channel"):
            if self.tx_mask is not None:
                llr = adapted_llrs_from_noise(c, noise, ebn0_db, self.rate,
                                              self.tx_mask, self.known_llr)
            else:
                llr = llrs_from_noise(c, noise, ebn0_db, self.rate)
        return u, llr

    def plain_counters(self, u: torch.Tensor, bits: torch.Tensor,
                       ok: torch.Tensor,
                       iters_used: torch.Tensor) -> torch.Tensor:
        """Kernel B's plain version: the (6,) int64 counters of a decoded
        batch, u as ``plain_llrs`` returns it."""
        info = self._info(bits)
        wrong = info != u
        if self.active_u is not None:
            wrong &= self.active_u == 1
        if self.crc_ok is not None:
            wrong = wrong[:, :self.kp]  # genie errors over payload bits
            passed = self.crc_ok(info)
        else:
            passed = ok
        frame_wrong = wrong.any(dim=1)
        return torch.stack([
            torch.full((), u.shape[0], dtype=torch.int64, device=u.device),
            wrong.sum(),
            frame_wrong.sum(),
            (~passed).sum(),
            (passed & frame_wrong).sum(),
            iters_used.sum(dtype=torch.int64),
        ])

    def __call__(self, generator: torch.Generator, ebn0_db: float,
                 out: torch.Tensor | None = None):
        return self.batch_counters(*self.draw(generator), ebn0_db,
                                   generator, out)


def build_batch_fn(code: LdpcCode, cfg: DecodeCfg, batch: int, adapt=None,
                   crc=None, *, device, fault_hook=None) -> BatchFn:
    return BatchFn(code, cfg, batch, device, adapt, crc, fault_hook)


@functools.lru_cache(maxsize=64)
@spanned("ldpc.build")
def _build_mc_step(code, cfg, batch, steps_per_call, device, adapt, crc):
    one_batch = BatchFn(code, cfg, batch, device, adapt, crc)

    @spanned("ldpc.mc.call")
    def step(seed: int, snr_idx: int, ebn0_db: float, ctr0: int):
        acc = torch.zeros(6, dtype=torch.int64, device=device)
        for t in range(steps_per_call):
            with span("ldpc.mc.batch"):
                gen = batch_generator(seed, snr_idx, ctr0 + t, device)
                one_batch(gen, ebn0_db, acc)
        return acc

    step.k = one_batch.k
    return step


def build_mc_step(code: LdpcCode, cfg: DecodeCfg, batch: int,
                  steps_per_call: int = 1, adapt=None, crc=None, *, device):
    """MC step: (seed, snr_idx, ebn0_db, ctr0) -> (6,) int64 counters on
    the device, summed over batches ctr0 .. ctr0 + steps_per_call - 1.
    Counter totals are identical for any steps_per_call grouping."""
    return _build_mc_step(code, cfg, batch, steps_per_call,
                          resolve_device(device), adapt, crc)


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
    adapt=None,
    crc=None,
    mesh=None,
    *,
    device,
) -> list[SnrResult]:
    """Frame-error-targeted Eb/N0 sweep on one device, or over the ranks
    of `mesh` (``dist/mesh.py::run_ber_sharded``: `batch` frames a rank,
    on the mesh's device, which `device` must name: its type, and its
    index where `device` gives one).

    device='cuda' raises when no card is present; it never runs on the
    CPU instead.  step_log: path for per-call JSONL records (snr,
    cumulative frames / errors, mean iters, wall time, info bits/s).
    adapt / crc: rate adaptation and outer CRC (see BatchFn)."""
    device = resolve_device(device)
    if mesh is not None:
        from tpu_ldpc_torch.dist.mesh import run_ber_sharded

        if mesh.device.type != device.type or device.index not in (
                None, mesh.device.index):
            raise ValueError(f"mesh computes on {mesh.device}, run_ber was "
                             f"asked for {device}")
        return run_ber_sharded(
            code, ebn0_grid, cfg, batch, target_frame_errors, max_frames,
            seed, mesh, progress=progress, state=state,
            steps_per_call=steps_per_call, step_log=step_log, adapt=adapt,
            crc=crc)
    if steps_per_call is None:
        steps_per_call = default_steps_per_call(device)
    step = build_mc_step(code, cfg, batch, steps_per_call, adapt, crc,
                         device=device)
    results = []
    for snr_idx, ebn0 in enumerate(ebn0_grid):
        with span("ldpc.mc.point"):
            res = SnrResult(ebn0_db=float(ebn0))
            batch_ctr = 0
            if state is not None:
                saved = state.load_point(snr_idx)
                if saved is not None:
                    res, batch_ctr = saved
            t0 = time.perf_counter()
            while (res.frame_errors < target_frame_errors
                   and res.frames < max_frames):
                acc = step(seed, snr_idx, float(ebn0), batch_ctr)
                with span("ldpc.mc.read"):
                    counters = acc.tolist()
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
