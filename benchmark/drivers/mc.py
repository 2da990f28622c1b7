"""Monte-Carlo traffic: a closed loop of calls of the program's MC step
(``sim/mc.py::build_mc_step``, the step ``run_ber`` runs: draws, encoder,
channel with the configuration's puncturing, decoder, six counters),
each followed by one host read of its counters, as ``run_ber`` does.
Call i draws batches steps_per_call * i onward of (seed, snr_idx 0).

Traffic keys: algo, iters, alpha, schedule, batch, steps_per_call,
ebn0_db, check_calls (calls recomputed by the reference, drawn from the
seed after the window).

End to end: mc_info_bits_per_s = frames * k of every call completed in
the window / window seconds.  Checks: counters_off, the counters of the
sampled calls that differ from the reference's; frames_off, the calls of
the window whose frame count is not steps_per_call * batch.
"""

from __future__ import annotations

import time

import numpy as np

from ldpcbench import reference
from ldpcbench.trace import WINDOW

LIMITS = {"counters_off": 0, "frames_off": 0}


def setup(ctx):
    from tpu_ldpc_torch.channel.adapt import RateAdapt
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    t, code = ctx.traffic, ctx.program_code()
    blocks = tuple(ctx.config["puncture_blocks"])
    adapt = (RateAdapt.from_blocks(code, puncture_blocks=blocks) if blocks
             else None)
    cfg = DecodeCfg(algo=t["algo"], iters=t["iters"], alpha=t["alpha"],
                    schedule=t["schedule"])
    step = build_mc_step(code, cfg, t["batch"], t["steps_per_call"], adapt,
                         device=ctx.device)
    if step.k != ctx.ref_code.k:
        raise ValueError(f"the program credits {step.k} info bits a frame, "
                         f"the configuration has k = {ctx.ref_code.k}")
    for _ in range(2):
        step(ctx.seed, 0, float(t["ebn0_db"]), 0).tolist()
    return {"step": step}


def measure(ctx, st):
    t = ctx.traffic
    step, spc, ebn0 = st["step"], int(t["steps_per_call"]), float(t["ebn0_db"])
    counters = []
    t0 = time.perf_counter()
    with ctx.tracer.span(WINDOW):
        while True:
            with ctx.tracer.span("bench.mc_call"):
                acc = step(ctx.seed, 0, ebn0, spc * len(counters))
            with ctx.tracer.span("bench.mc_read"):
                counters.append(acc.tolist())
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    wall = time.perf_counter() - t0
    st["counters"] = c = np.asarray(counters, dtype=np.int64)
    frames = int(c[:, 0].sum())
    return {"attempted": len(c), "failed": 0,
            "metrics": {"mc_info_bits_per_s": frames * ctx.ref_code.k / wall},
            "readings": {"calls": len(c), "decodes": len(c) * spc,
                         "frames": frames, "frame_iters": int(c[:, 5].sum()),
                         "algo": t["algo"]}}


def _sample(ctx, n_calls):
    rng = np.random.default_rng([ctx.seed, 2])
    k = min(int(ctx.traffic["check_calls"]), n_calls)
    return sorted(int(i) for i in rng.choice(n_calls, size=k, replace=False))


def _reference_counters(ctx, calls, msg_bf16=False):
    t = ctx.traffic
    dec = reference.Decoder(ctx.ref_code, t["algo"], t["iters"], t["alpha"],
                            True, msg_bf16=msg_bf16)
    mc = reference.MonteCarlo(ctx.ref_code, dec, t["batch"],
                              ctx.config["puncture_blocks"], ctx.device)
    spc = int(t["steps_per_call"])
    return np.stack([mc.call_counters(ctx.seed, 0, spc * i, spc,
                                      float(t["ebn0_db"])) for i in calls])


def check(ctx, st):
    st.pop("step", None)
    c, t = st["counters"], ctx.traffic
    calls = _sample(ctx, len(c))
    want = _reference_counters(ctx, calls)
    frames_off = int((c[:, 0] != t["steps_per_call"] * t["batch"]).sum())
    return [("counters_off", int((c[calls] != want).sum()),
             LIMITS["counters_off"]),
            ("frames_off", frames_off, LIMITS["frames_off"])]


def control(ctx, st):
    """counters_off of the reference with bf16 message storage in the
    program's place, over the same sampled calls."""
    calls = _sample(ctx, len(st["counters"]))
    want = _reference_counters(ctx, calls)
    got = _reference_counters(ctx, calls, msg_bf16=True)
    return [("counters_off", int((got != want).sum()))]
