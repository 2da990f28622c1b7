"""Registry-wide timing of the single-pass decoders on the H100, across
the cells of scripts/tune_registry_knobs.py.  Imports only
tpu_ldpc_torch.

For each cell (the TPU script's 37 registry cells at its operating
points, plus the judged code and nr2_r15_z64 at the points the TPU
measured them), at b=4096, min-sum alpha 0.75, in the code's own
coordinates (as decode() and run_ber decode), on one
benchcore.make_timer's buffers (CUDA events around back-to-back decodes
of L2-busting buffers): layered-25 with early termination, layered-25
with it off (fixed work, the audit's fit) and flooding-50 with it off
(K1 in the headline's form).  The row also holds the mean iterations of
the early-terminated decode on the timer's first buffer.
scripts/torch_roofline_audit.py fits the rows with early termination
off.

A cell whose decoders build_cuda_decoder refuses (NotImplementedError
or ValueError from check_modes or the kernel plans) is recorded as
``skipped`` with the refusal's words; any other exception raises.  The
artifact is rewritten atomically after each cell; a rerun resumes,
skipping the cells it holds, unless --retune.

    python scripts/torch_tune_registry_knobs.py --out PATH  # the card
    python scripts/torch_tune_registry_knobs.py --out PATH --retune

writes PATH (default artifacts/h100_registry_knobs.json, whose cells
were measured with other settings: a run refuses to resume an artifact
whose settings differ from its own).  --device cpu runs the plain
decoder (a rehearsal of the protocol; its times are the host's).
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
# cells the TPU measured apart, at the points it measured them
JUDGED_EBN0 = 2.0
NR2_R15_Z64_EBN0 = 1.0

BATCH = 4096
ITERS = 25  # layered-25 == flooding-50 FER (artifacts/judged_layered25.csv)
FLOOD_ITERS = 50
ALPHA = 0.75
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
    from tpu_ldpc_torch.benchcore import make_timer

    t0 = time.time()
    try:
        decoders = build_decoders(code)
    except (NotImplementedError, ValueError) as e:
        return {"skipped": f"{type(e).__name__}: {e}"}
    timer = make_timer(code, batch, ebn0, device=device)
    iters_used = decoders["single_et"](timer.llrs[0])[2]
    row = {"n": code.n, "k": code.k, "Z": code.Z, "E": int(code.layout.E),
           "ebn0_db": ebn0,
           "single_et_mean_iters": float(iters_used.double().mean())}
    for label, fn in decoders.items():
        m = timer.measure(fn, reps)
        row[f"{label}_ms"] = m["median_s"] * 1e3
        row[f"{label}_dec_ms"] = m["dec_ms"]
        row[f"{label}_gbps"] = batch * code.k / m["median_s"] / 1e9
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
                "alpha": ALPHA, "reps": REPS, "coordinates": "plain",
                "device": device.type}
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
        print(f"{code.name} {ebn0} dB: layered ET "
              f"{row['single_et_ms']:.4f} ms (mean iters "
              f"{row['single_et_mean_iters']:.3f}), layered ET off "
              f"{row['layered_etoff_ms']:.4f}, flooding ET off "
              f"{row['flood_etoff_ms']:.4f}, wall {row['wall_s']} s",
              flush=True)
    print(f"DONE {len(results['cells'])} cells", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
