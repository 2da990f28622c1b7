"""Monte-Carlo traffic sharded over the cell's cards: a closed loop of
calls of the program's SPMD MC step (``dist/mesh.py::
build_sharded_mc_step``: every rank draws, encodes, transmits, decodes
and counts its own batches, then one ``all_reduce`` of the six counters
a call), each followed by one host read of the summed counters, as
``run_ber_sharded`` does.  Call i runs batches steps_per_call * i onward
of (seed, snr_idx 0) on every rank, rank r on the streams of
(seed, 0, batch, r).  After each read rank 0 decides whether the window
is over; the ranks all-reduce that flag on the host (a gloo group of
their own) while the cards run the next call, and stop after reading it,
so every rank makes the same number of calls and the flag costs the
cards no time.

Traffic keys: as ``mc.py``'s; batch is a rank's batch.

End to end: mc_info_bits_per_s.x4 = the summed frames * k of every call
completed in the window / rank 0's window seconds.  Checks:
counters_off, the counters of the sampled calls that differ from the
sum of the reference's rank streams (recomputed on rank 0's card: the
ranks run one program on one model of card, so a stream repeats there);
frames_off, the calls of the window whose frame count is not
ranks * steps_per_call * batch; ranks_off, the ranks whose calls or
summed counters over the window differ from rank 0's (every rank has to
hold the same totals).
"""

from __future__ import annotations

import datetime
import time

import numpy as np

from ldpcbench import reference
from ldpcbench.ranks import GROUP_TIMEOUT_S
from ldpcbench.trace import WINDOW

LIMITS = {"counters_off": 0, "frames_off": 0, "ranks_off": 0}


def setup(ctx):
    import torch.distributed as dist
    from tpu_ldpc_torch.channel.adapt import RateAdapt
    from tpu_ldpc_torch.dist.mesh import build_sharded_mc_step, make_mesh
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    t, code = ctx.traffic, ctx.program_code()
    blocks = tuple(ctx.config["puncture_blocks"])
    adapt = (RateAdapt.from_blocks(code, puncture_blocks=blocks) if blocks
             else None)
    cfg = DecodeCfg(algo=t["algo"], iters=t["iters"], alpha=t["alpha"],
                    schedule=t["schedule"])
    mesh = make_mesh(device=ctx.device)
    if mesh.size != ctx.world:
        raise ValueError(f"the group has {mesh.size} ranks, the cell "
                         f"{ctx.world}")
    step = build_sharded_mc_step(code, cfg, t["batch"], mesh,
                                 t["steps_per_call"], adapt)
    if step.k != ctx.ref_code.k:
        raise ValueError(f"the program credits {step.k} info bits a frame, "
                         f"the configuration has k = {ctx.ref_code.k}")
    st = {"step": step, "rank": mesh.rank, "host": dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))}
    for _ in range(2):
        acc = step(ctx.seed, 0, float(t["ebn0_db"]), 0)
        _agree(st, False)
        acc.tolist()
    return st


def _agree(st, over: bool) -> bool:
    """Rank 0's decision, held by every rank (host tensors, gloo)."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(over and st["rank"] == 0)], dtype=torch.int32)
    dist.all_reduce(flag, group=st["host"])
    return bool(flag.item())


def measure(ctx, st):
    import torch
    import torch.distributed as dist

    t = ctx.traffic
    step, spc, ebn0 = st["step"], int(t["steps_per_call"]), float(t["ebn0_db"])
    counters, over = [], False
    t0 = time.perf_counter()
    with ctx.tracer.span(WINDOW):
        while True:
            with ctx.tracer.span("bench.mc_call"):
                acc = step(ctx.seed, 0, ebn0, spc * len(counters))
            with ctx.tracer.span("bench.mc_stop"):
                stop = _agree(st, over)
            with ctx.tracer.span("bench.mc_read"):
                counters.append(acc.tolist())
            over = time.perf_counter() - t0 >= ctx.seconds
            if stop:
                break
    wall = time.perf_counter() - t0
    st["counters"] = c = np.asarray(counters, dtype=np.int64)
    # every rank's calls and summed counters, for ranks_off
    mine = torch.tensor([len(c), *c.sum(axis=0)], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(ctx.world)]
    dist.all_gather(every, mine, group=st["host"])
    st["ranks"] = np.asarray([x.tolist() for x in every], dtype=np.int64)
    frames = int(c[:, 0].sum())
    return {"attempted": len(c), "failed": 0,
            "metrics": {"mc_info_bits_per_s.x4":
                        frames * ctx.ref_code.k / wall},
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
                                      float(t["ebn0_db"]), ranks=ctx.world)
                     for i in calls])


def check(ctx, st):
    st.pop("step", None)
    st.pop("host", None)
    c, t = st["counters"], ctx.traffic
    calls = _sample(ctx, len(c))
    want = _reference_counters(ctx, calls)
    per_call = ctx.world * t["steps_per_call"] * t["batch"]
    ranks = st["ranks"]
    return [("counters_off", int((c[calls] != want).sum()),
             LIMITS["counters_off"]),
            ("frames_off", int((c[:, 0] != per_call).sum()),
             LIMITS["frames_off"]),
            ("ranks_off", int((ranks != ranks[0]).any(axis=1).sum()),
             LIMITS["ranks_off"])]


def control(ctx, st):
    """counters_off of the reference with bf16 message storage in the
    program's place, over the same sampled calls and rank streams."""
    calls = _sample(ctx, len(st["counters"]))
    want = _reference_counters(ctx, calls)
    got = _reference_counters(ctx, calls, msg_bf16=True)
    return [("counters_off", int((got != want).sum()))]
