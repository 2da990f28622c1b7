"""Decode-only traffic: back-to-back calls of the program's throughput
decoder (``cli/bench.py::build_bench_decoder``, i.e.
``decode/api.py::build_decode_fn``) over LLR buffers made on the card from
the seed, with no host synchronisation inside the window; the window
closes on a synchronize.

Traffic keys: algo, iters, alpha, schedule, early_stop, batch, ebn0_db,
buffers (LLR batches cycled through), check_calls (calls whose outputs
are kept, a reservoir sample drawn from the seed, and compared with the
reference after the window).

End to end: decode_info_bits_per_s = calls * batch * k / window seconds.
Check: frames_off, the frames of the kept calls whose bits, ok or
iters_used differ from the reference's decode of the same buffer.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ldpcbench import reference
from ldpcbench.trace import WINDOW
from ldpcbench.traffic import llr_buffers

LIMITS = {"frames_off": 0}


def setup(ctx):
    from tpu_ldpc_torch.cli.bench import build_bench_decoder

    t = ctx.traffic
    fn = build_bench_decoder(
        ctx.program_code(), iters=t["iters"], algo=t["algo"],
        alpha=t["alpha"], schedule=t["schedule"],
        early_stop=t["early_stop"], device=ctx.device)
    bufs = llr_buffers(ctx.ref_code, t["batch"], t["ebn0_db"],
                       t["buffers"], ctx.seed, ctx.device)
    for b in bufs:
        fn(b)
    return {"fn": fn, "bufs": bufs}


def measure(ctx, st):
    fn, bufs = st["fn"], st["bufs"]
    keep = int(ctx.traffic["check_calls"])
    rng = np.random.default_rng([ctx.seed, 1])
    kept, calls = [], 0
    t0 = time.perf_counter()
    with ctx.tracer.span(WINDOW):
        while True:
            with ctx.tracer.span("bench.decode_call"):
                out = fn(bufs[calls % len(bufs)])
            calls += 1
            if len(kept) < keep:
                kept.append((calls - 1, out))
            else:
                j = int(rng.integers(calls))
                if j < keep:
                    kept[j] = (calls - 1, out)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
    wall = time.perf_counter() - t0
    st["kept"] = kept
    t, code = ctx.traffic, ctx.ref_code
    frames = calls * t["batch"]
    return {"attempted": calls, "failed": 0,
            "metrics": {"decode_info_bits_per_s": frames * code.k / wall},
            "readings": {
                "calls": calls, "decodes": calls, "frames": frames,
                # every iteration runs with early termination off
                "frame_iters": (None if t["early_stop"]
                                else frames * t["iters"]),
                "algo": t["algo"]}}


def _frames_off(kept, want):
    off = 0
    for i, (bits, ok, iu) in kept:
        wb, wok, wiu = want[i % len(want)]
        same = ((bits == wb).all(dim=1) & (ok == wok)
                & (iu.to(torch.int32) == wiu))
        off += int((~same).sum())
    return off


def _reference(ctx, st, msg_bf16=False):
    t = ctx.traffic
    dec = reference.Decoder(ctx.ref_code, t["algo"], t["iters"], t["alpha"],
                            t["early_stop"], msg_bf16=msg_bf16)
    return [dec(b) for b in st["bufs"]]


def check(ctx, st):
    st.pop("fn", None)
    kept = st["kept"]
    off = _frames_off(kept, _reference(ctx, st))
    return [("frames_off", off, LIMITS["frames_off"])]


def control(ctx, st):
    """frames_off of the program's bf16 message storage (K7) decoding the
    same buffers."""
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

    t = ctx.traffic
    k7 = build_cuda_decoder(ctx.program_code(), t["algo"], t["iters"],
                            t["alpha"], 0.0, t["schedule"], t["early_stop"],
                            normalize=False, msg_dtype=torch.bfloat16)
    outs = [(i, k7(b)) for i, b in enumerate(st["bufs"])]
    return [("frames_off", _frames_off(outs, _reference(ctx, st)))]
