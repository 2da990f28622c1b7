"""The port's throughput timer: the one estimator every bench entry point
of the port shares (the role of ``tpu_ldpc/benchcore.py``, not its
method).

``make_timer(code, batch, ebn0_db, device=...)`` draws ``n_buffers``
distinct batches on the device once, from one ``torch.Generator``:
random info bits through the generator encoder give each buffer's BPSK
codeword x, and a unit-normal draw its noise.  The LLRs are
``scale * (x + sig * noise)`` with ``sig**2 = noise_sigma2(ebn0_db,
rate)`` and ``scale = 2 / sig**2``, the JAX timer's operating point;
``n_punct`` leading positions are erased (exactly 0), the NR operating
condition, and Eb/N0 then references k / (n - n_punct) unless ``rate``
is given.  On the card the buffers together exceed its L2 cache (up to
``MAX_BUFFERS`` of them), so a decode reads its input from device memory
as a fresh input would, and not from the L2 where an earlier call left
it.

``timer.measure(fn, reps)`` warms up, then times ``reps`` back-to-back
calls that cycle through the buffers, ``REPEATS`` times.  On the card the
calls lie between two CUDA events recorded on the current stream, with
one synchronize after the second: the time is the card's, not the
enqueue's.  On the CPU (the tests' path) ``time.perf_counter`` brackets
the same loop.  ``timer.measure_at(fn, scale, sig, reps)`` times the same
way at another operating point: ``timer.buffers_at(scale, sig)``, the
buffers rebuilt from the kept x and noise (the IR-HARQ stages'
channels), kept while the point stays.

The JAX timer subtracts a generation-only loop, pairs deltas and runs 60
decodes inside one device computation because a remote TPU costs ~25 ms
a dispatch and caches repeated computations.  The card has neither, so
nothing is subtracted and there is no ``gen_ms``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from tpu_ldpc_torch.channel.awgn import bpsk, noise_sigma2
from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.encode.encoder import select_encoder

MAX_BUFFERS = 64
CPU_BUFFERS = 4
REPEATS = 5  # timed runs a measure
WARMUP = 2   # untimed decodes before them
L2_FALLBACK_BYTES = 50 * 2**20  # the H100's L2, if the card does not say


def smi(query: str = "name,power.limit") -> str:
    """The first card's `query` fields as ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader`` gives them; by default its name and power
    limit, which every recorded time stands beside."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def dump_json_atomic(path: str, obj) -> None:
    """Write `obj` as JSON to `path` through a temporary file and a rename,
    so an interrupted run leaves the last whole artifact."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def default_buffers(batch_bytes: int, device: torch.device) -> int:
    """The fewest buffers whose bytes together exceed the card's L2 (at
    least 2, at most MAX_BUFFERS); CPU_BUFFERS on the CPU."""
    if device.type != "cuda":
        return CPU_BUFFERS
    l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                 0) or L2_FALLBACK_BYTES
    return min(MAX_BUFFERS, max(2, l2 // batch_bytes + 1))


class LoopTimer:
    """Times decode functions, llr (batch, n) -> outputs, over LLR
    batches on one device: ``llrs``, built as scale * (x + sig * noise)
    from each buffer's BPSK codeword ``xs[i]`` and unit-normal draw
    ``noises[i]``, the first ``n_punct`` columns 0."""

    def __init__(self, xs: list[torch.Tensor], noises: list[torch.Tensor],
                 scale: float, sig: float, n_punct: int = 0):
        self.xs, self.noises = xs, noises
        self.scale, self.sig = float(scale), float(sig)
        self.n_punct = int(n_punct)
        self.device = xs[0].device
        self.llrs = self._build(self.scale, self.sig)
        self._at = ((self.scale, self.sig), self.llrs)

    def _build(self, scale: float, sig: float) -> list[torch.Tensor]:
        llrs = []
        for x, noise in zip(self.xs, self.noises):
            llr = scale * (x + sig * noise)
            llr[:, :self.n_punct] = 0.0
            llrs.append(llr.contiguous())
        return llrs

    def _run(self, fn, reps: int, llrs) -> float:
        """Seconds for `reps` calls of fn, cycling through `llrs`."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for i in range(reps):
                fn(llrs[i % len(llrs)])
            return time.perf_counter() - t0
        with torch.cuda.device(self.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(reps):
                fn(llrs[i % len(llrs)])
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3

    def _measure(self, fn, reps: int, llrs) -> dict:
        reps = max(1, int(reps))
        self._run(fn, WARMUP, llrs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        per_batch = [self._run(fn, reps, llrs) / reps
                     for _ in range(REPEATS)]
        return {"median_s": float(np.median(per_batch)),
                "best_s": float(min(per_batch)),
                "dec_ms": [t * 1e3 for t in per_batch]}

    def measure(self, fn, reps: int = 30) -> dict:
        """Per-batch seconds of fn: {"median_s", "best_s"} over REPEATS
        timed runs of `reps` calls, and "dec_ms", each run's ms a batch."""
        return self._measure(fn, reps, self.llrs)

    def buffers_at(self, scale: float, sig: float) -> list[torch.Tensor]:
        """The LLR buffers of the operating point (scale, sig), rebuilt as
        scale * (x + sig * noise), erased positions 0, and reused while
        the point stays the same."""
        point = (float(scale), float(sig))
        if self._at[0] != point:
            self._at = None  # free the last point's buffers first
            self._at = (point, self._build(*point))
        return self._at[1]

    def measure_at(self, fn, scale: float, sig: float,
                   reps: int = 30) -> dict:
        """``measure`` over ``buffers_at(scale, sig)``."""
        return self._measure(fn, reps, self.buffers_at(scale, sig))


def make_timer(code: LdpcCode, batch: int, ebn0_db: float = 2.0, *, device,
               n_buffers: int | None = None, seed: int = 0,
               n_punct: int = 0, rate: float | None = None) -> LoopTimer:
    """LoopTimer over `n_buffers` batches of `batch` random codewords of
    `code` at `ebn0_db`, drawn on `device` from a generator seeded with
    `seed`.  n_buffers=None: ``default_buffers``.

    As the JAX timer: sigma^2 = noise_sigma2(ebn0_db, rate), rate
    k / (n - n_punct) when n_punct is set and `rate` is not, else
    code.rate; the first n_punct LLRs of every buffer are 0 (positions
    never transmitted).  HARQ stages pass the first transmission's
    payload rate as `rate`."""
    device = resolve_device(device)
    if n_buffers is None:
        n_buffers = default_buffers(batch * code.n * 4, device)
    if rate is None:
        rate = code.k / (code.n - n_punct) if n_punct else code.rate
    sigma2 = noise_sigma2(ebn0_db, rate)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    encode_fn, k, _ = select_encoder(code, device=device)
    xs, noises = [], []
    for _ in range(int(n_buffers)):
        u = torch.randint(0, 2, (batch, k), generator=gen, device=device,
                          dtype=torch.uint8)
        xs.append(bpsk(encode_fn(u)))
        noises.append(torch.randn(xs[-1].shape, generator=gen, device=device,
                                  dtype=torch.float32))
    return LoopTimer(xs, noises, 2.0 / sigma2, float(np.sqrt(sigma2)),
                     n_punct)
