"""Registry-wide layered two-phase knob tuning on the H100, the twin of
scripts/tune_registry_knobs.py.  Imports only tpu_ldpc_torch.

For each cell (the TPU script's 37 registry cells at its operating
points, plus the judged code and nr2_r15_z64 at the knob table's), at
b=4096, min-sum alpha 0.75, layered 25 iterations, in the code's own
coordinates (as decode() and run_ber decode):

  1. tune_phase1_iters (seed 3) picks (K, budget) from the iteration
     distribution on the card;
  2. the two-phase decoder with that K and budget is timed by
     benchcore.make_timer / LoopTimer.measure (CUDA events around
     back-to-back decodes of L2-busting buffers);
  3. the fallback probe: the two-phase decoder with report_fallback=True
     on the timer's first batch of codewords under seed-11 noise; its
     bits, ok and iters_used must equal single-pass ET's there;
  4. on the same timer's buffers: single-pass layered-25 with ET on
     (what two-phase must beat: their outputs are the same), layered-25
     with ET off (fixed work, the audit's fit) and flooding-50 with ET off
     (K1 in the headline's form).

A cell whose decoders build_cuda_decoder refuses (NotImplementedError
or ValueError from check_modes or the kernel plans) is recorded as
``skipped`` with the refusal's words; any other exception raises.  The
artifact is rewritten atomically after each cell; a rerun resumes,
skipping the cells it holds, unless --retune.  The knob table
(tpu_ldpc_torch/codes/data/twophase_knobs.json) is not written: it stays
the JAX package's.

    python scripts/torch_tune_registry_knobs.py            # the card
    python scripts/torch_tune_registry_knobs.py --retune   # all cells anew

writes artifacts/h100_registry_knobs.json (--out PATH elsewhere).  A
resumed run refuses an artifact whose settings differ from its own.
--device cpu runs the plain decoder (a rehearsal of the protocol; its
times are the host's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "artifacts", "h100_registry_knobs.json")

# the TPU script's operating points: near the min-sum FER ~1e-2 point by
# rate for the wifi / wimax cells, the measured NR-like waterfalls for
# the others (scripts/tune_registry_knobs.py)
EBN0_BY_RATE = {"1/2": 1.9, "2/3": 2.4, "3/4": 2.8, "5/6": 3.6}
NR1_Z64 = (("1/2", 1.65), ("2/3", 2.6), ("3/4", 2.9), ("5/6", 3.4))
NR1_Z32 = (("1/2", 2.05), ("2/3", 3.0), ("3/4", 3.3), ("5/6", 3.8))
NR2_Z32 = (("1/5", 1.4), ("2/7", 1.7), ("2/5", 2.1), ("1/2", 2.4),
           ("2/3", 3.0))
# cells the TPU tuned apart, at the knob table's points
JUDGED_EBN0 = 2.0
NR2_R15_Z64_EBN0 = 1.0

BATCH = 4096
ITERS = 25  # layered-25 == flooding-50 FER (artifacts/judged_layered25.csv)
FLOOD_ITERS = 50
ALPHA = 0.75
TUNE_SEED = 3
PROBE_SEED = 11
REPS = 30
PLAIN = {"normalize": False}  # the code's own coordinates, as decode()


def cells():
    """[(code, Eb/N0)] in the TPU script's order, then the judged code
    and nr2_r15_z64."""
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    out = [(LdpcCode.from_family(fam, rate, z), EBN0_BY_RATE[rate])
           for fam, lifts in (("wifi", (27, 54, 81)), ("wimax", (24, 48, 96)))
           for rate in ("1/2", "2/3", "3/4", "5/6") for z in lifts]
    out += [(nrlike_code(rate, 64), ebn0) for rate, ebn0 in NR1_Z64]
    out += [(nrlike_code(rate, 32), ebn0) for rate, ebn0 in NR1_Z32]
    out += [(nrlike_code(rate, 32, bg=2), ebn0) for rate, ebn0 in NR2_Z32]
    out += [(LdpcCode.judged(), JUDGED_EBN0),
            (nrlike_code("1/5", 64, bg=2), NR2_R15_Z64_EBN0)]
    return out


def build_decoders(code):
    """The cell's single-pass decoders by label (early termination,
    schedule, iterations); raises build_cuda_decoder's refusals."""
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

    return {label: build_cuda_decoder(code, "minsum", iters, ALPHA, 0.0,
                                      sched, et, **PLAIN)
            for label, sched, iters, et in (
                ("single_et", "layered", ITERS, True),
                ("layered_etoff", "layered", ITERS, False),
                ("flood_etoff", "flooding", FLOOD_ITERS, False))}


def measure_cell(code, ebn0, device, batch, reps):
    """One cell's row (module docstring), or {"skipped": words}."""
    import torch

    from tpu_ldpc_torch.benchcore import make_timer
    from tpu_ldpc_torch.decode.twophase import (
        build_twophase_decoder, tune_phase1_iters)

    t0 = time.time()
    try:
        decoders = build_decoders(code)
    except (NotImplementedError, ValueError) as e:
        return {"skipped": f"{type(e).__name__}: {e}"}
    K, budget, stats = tune_phase1_iters(
        code, ebn0, batch=batch, iters=ITERS, seed=TUNE_SEED, device=device,
        schedule="layered", alpha=ALPHA, **PLAIN)
    twophase = build_twophase_decoder(
        code, ITERS, K, budget, report_fallback=True, algo="minsum",
        alpha=ALPHA, schedule="layered", **PLAIN)
    timer = make_timer(code, batch, ebn0, device=device)
    # the probe: the timer's first codewords under seed-11 noise
    gen = torch.Generator(device=device)
    gen.manual_seed(PROBE_SEED)
    x = timer.xs[0]
    llr = timer.scale * (x + timer.sig * torch.randn(
        x.shape, generator=gen, device=device, dtype=torch.float32))
    *probe, n_unconv = twophase(llr)
    single = decoders["single_et"](llr)
    same = all(torch.equal(a, b) for a, b in zip(probe, single))
    row = {"n": code.n, "k": code.k, "Z": code.Z, "E": int(code.layout.E),
           "ebn0_db": ebn0, "K": K, "budget": budget, "tune_stats": stats,
           "n_unconv_seed11": int(n_unconv),
           "fallback_fired": int(n_unconv) > budget,
           "probe_twophase_equals_single_et": same,
           "probe_mean_iters": float(single[2].double().mean())}
    timed = {"layered_twophase": lambda v: twophase(v)[:3], **decoders}
    for label, fn in timed.items():
        m = timer.measure(fn, reps)
        row[f"{label}_ms"] = m["median_s"] * 1e3
        row[f"{label}_dec_ms"] = m["dec_ms"]
        row[f"{label}_gbps"] = batch * code.k / m["median_s"] / 1e9
    row["twophase_over_single_et"] = (row["layered_twophase_ms"]
                                      / row["single_et_ms"])
    row["wall_s"] = round(time.time() - t0, 1)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu runs the plain decoder")
    p.add_argument("--retune", action="store_true",
                   help="measure the cells the artifact already holds")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    import torch

    from tpu_ldpc_torch.benchcore import dump_json_atomic, smi
    from tpu_ldpc_torch.codes_device import resolve_device

    device = resolve_device(args.device)
    settings = {"batch": BATCH, "iters": ITERS, "flood_iters": FLOOD_ITERS,
                "alpha": ALPHA, "tune_seed": TUNE_SEED,
                "probe_seed": PROBE_SEED, "reps": REPS,
                "coordinates": "plain", "device": device.type}
    results = {"cells": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            held = json.load(f)
        if held.get("settings") != settings:
            raise SystemExit(
                f"{args.out} holds cells measured with "
                f"{held.get('settings')}, not this run's {settings}: move "
                f"it away to measure afresh")
        results["cells"] = held["cells"]
    results.update({
        "date": time.strftime("%Y-%m-%d %H:%M"),
        "device": smi() if device.type == "cuda" else "cpu",
        "torch": torch.__version__, "settings": settings})
    print(f"[tune] {results['device']}", flush=True)
    for code, ebn0 in cells():
        if code.name in results["cells"] and not args.retune:
            print(f"{code.name}: done, skip", flush=True)
            continue
        row = measure_cell(code, ebn0, device, BATCH, REPS)
        results["cells"][code.name] = row
        dump_json_atomic(args.out, results)
        if "skipped" in row:
            print(f"{code.name}: SKIP ({row['skipped']})", flush=True)
            continue
        print(f"{code.name} {ebn0} dB K={row['K']} budget={row['budget']} "
              f"n_unconv={row['n_unconv_seed11']}: two-phase "
              f"{row['layered_twophase_ms']:.4f} ms, single ET "
              f"{row['single_et_ms']:.4f}, layered ET off "
              f"{row['layered_etoff_ms']:.4f}, flooding ET off "
              f"{row['flood_etoff_ms']:.4f} (ratio "
              f"{row['twophase_over_single_et']:.3f}), wall "
              f"{row['wall_s']} s", flush=True)
    bad = [name for name, r in results["cells"].items()
           if r.get("probe_twophase_equals_single_et") is False]
    print(f"DONE {len(results['cells'])} cells; two-phase != single ET on "
          f"{bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
