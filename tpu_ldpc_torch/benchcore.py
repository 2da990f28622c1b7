"""The port's throughput timer: the one estimator every bench entry point
of the port shares (the role of ``tpu_ldpc/benchcore.py``, not its
method).

``make_timer(code, batch, ebn0_db, device=...)`` draws ``n_buffers``
distinct LLR batches on the device once, from one ``torch.Generator``:
random info bits through the generator encoder, then BPSK over AWGN at
``ebn0_db``.  On the card the buffers together exceed its L2 cache (up
to ``MAX_BUFFERS`` of them), so a decode reads its input from device
memory as a fresh input would, and not from the L2 where an earlier call
left it.

``timer.measure(fn, reps)`` warms up, then times ``reps`` back-to-back
calls that cycle through the buffers, ``REPEATS`` times.  On the card the
calls lie between two CUDA events recorded on the current stream, with
one synchronize after the second: the time is the card's, not the
enqueue's.  On the CPU (the tests' path) ``time.perf_counter`` brackets
the same loop.

The JAX timer subtracts a generation-only loop, pairs deltas and runs 60
decodes inside one device computation because a remote TPU costs ~25 ms
a dispatch and caches repeated computations.  The card has neither, so
nothing is subtracted and there is no ``gen_ms``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_ldpc_torch.channel.awgn import awgn_llrs
from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.encode.encoder import select_encoder

MAX_BUFFERS = 64
CPU_BUFFERS = 4
REPEATS = 5  # timed runs a measure
WARMUP = 2   # untimed decodes before them
L2_FALLBACK_BYTES = 50 * 2**20  # the H100's L2, if the card does not say


def default_buffers(batch_bytes: int, device: torch.device) -> int:
    """The fewest buffers whose bytes together exceed the card's L2 (at
    least 2, at most MAX_BUFFERS); CPU_BUFFERS on the CPU."""
    if device.type != "cuda":
        return CPU_BUFFERS
    l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                 0) or L2_FALLBACK_BYTES
    return min(MAX_BUFFERS, max(2, l2 // batch_bytes + 1))


class LoopTimer:
    """Times decode functions, llr (batch, n) -> outputs, over `llrs`,
    a list of LLR batches on one device."""

    def __init__(self, llrs: list[torch.Tensor]):
        self.llrs = llrs
        self.device = llrs[0].device

    def _run(self, fn, reps: int) -> float:
        """Seconds for `reps` calls of fn, cycling through the buffers."""
        llrs = self.llrs
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

    def measure(self, fn, reps: int = 30) -> dict:
        """Per-batch seconds of fn: {"median_s", "best_s"} over REPEATS
        timed runs of `reps` calls, and "dec_ms", each run's ms a batch."""
        reps = max(1, int(reps))
        self._run(fn, WARMUP)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        per_batch = [self._run(fn, reps) / reps for _ in range(REPEATS)]
        return {"median_s": float(np.median(per_batch)),
                "best_s": float(min(per_batch)),
                "dec_ms": [t * 1e3 for t in per_batch]}


def make_timer(code: LdpcCode, batch: int, ebn0_db: float = 2.0, *, device,
               n_buffers: int | None = None, seed: int = 0) -> LoopTimer:
    """LoopTimer over `n_buffers` batches of `batch` random codewords of
    `code` at `ebn0_db` (Eb/N0 referenced to code.rate, as the JAX
    timer), drawn on `device` from a generator seeded with `seed`.
    n_buffers=None: ``default_buffers``."""
    device = resolve_device(device)
    if n_buffers is None:
        n_buffers = default_buffers(batch * code.n * 4, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    encode_fn, k, _ = select_encoder(code, device=device)
    llrs = []
    for _ in range(int(n_buffers)):
        u = torch.randint(0, 2, (batch, k), generator=gen, device=device,
                          dtype=torch.uint8)
        llrs.append(awgn_llrs(encode_fn(u), ebn0_db, code.rate,
                              gen).contiguous())
    return LoopTimer(llrs)
