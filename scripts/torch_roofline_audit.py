"""Edge-rate audit across the tuned registry, the twin of
scripts/roofline_audit.py.  Imports only tpu_ldpc_torch; runs on the
host (it reads an artifact and builds layouts).

It reads a knob artifact of either tuner (``--knobs``: the TPU's
artifacts/tpu_registry_knobs.json or the H100's
artifacts/h100_registry_knobs.json) and fits the TPU audit's model to
each kernel form's rows:

    edge-iterations/frame  =  E * (K + (iters - K) * B / batch)
    ps per edge-iteration  =  c1 + c2 * [Z % 8 != 0] + c3 * rowdeg

E the lifted edges, K and B the two-phase knobs, least squares on the
frame time.  The two-phase rows (``layered_twophase_gbps``, the TPU
artifact's and an older H100 artifact's) are fit as the TPU audit fits
them.  An H100 artifact holds layered-25 and flooding-50 rows with early
termination off; their edge-iterations are exactly E * iters, and each
form gets a fit of its own.  The ``bucket`` column holds the kernel's
form on the card for the row's schedule: the layered slot form of
decode/layered_plan.py (two-phase and layered rows) or the flooding
bucket of decode/flood_plan.py (0: the two-pass form), so the residuals
can be read by form.  Each fit's rows are also fit to the slots the
kernel walks per edge, ps/edge = a + b * bucket / rowdeg (a row of mean
degree rowdeg padded to the bucket's slots; the two-pass rows, bucket 0,
left out).

    python scripts/torch_roofline_audit.py
    python scripts/torch_roofline_audit.py \\
        --knobs artifacts/tpu_registry_knobs.json --out build/tpu_audit.csv

writes artifacts/h100_roofline_audit.csv by default and prints each fit
with its residuals.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
KNOBS_ART = os.path.join(REPO, "artifacts", "h100_registry_knobs.json")
OUT = os.path.join(REPO, "artifacts", "h100_roofline_audit.csv")

BATCH = 4096
ITERS = 25  # the tuner's layered budget (layered-25 == flooding-50 FER)
# fit name -> (the artifact's Gb/s key, schedule, iterations, two-phase)
FITS = {"twophase": ("layered_twophase_gbps", "layered", ITERS, True),
        "layered_etoff": ("layered_etoff_gbps", "layered", ITERS, False),
        "flood_etoff": ("flood_etoff_gbps", "flooding", 50, False)}
FIELDS = ["cell", "n", "k", "E_lifted", "K", "budget", "z_aligned",
          "row_degree", "edge_iters_per_frame", "measured_gbps",
          "predicted_gbps", "residual_pct", "ps_per_edge", "note", "fit",
          "bucket"]


def build_cell(name):
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    if name in ("judged", "qc1024_r12"):
        return LdpcCode.judged()
    fam, rate, z = name.split("_")
    rate = rate[1] + "/" + rate[2]
    z = int(z[1:])
    if fam in ("wifi", "wimax"):
        return LdpcCode.from_family(fam, rate, z)
    assert fam.startswith("nr")
    return nrlike_code(rate, z, bg=int(fam[2:]))


def bucket(code, schedule, early_stop):
    """The kernel's form for `code` in its own coordinates."""
    from tpu_ldpc_torch.decode.flood_plan import flood_plan
    from tpu_ldpc_torch.decode.layered_plan import layered_plan
    from tpu_ldpc_torch.decode.normalize import coordinates

    shifts = coordinates(code, False)[0]
    if schedule == "layered":
        return layered_plan(code, shifts, 4, early_stop).bucket
    return flood_plan(code, shifts).bucket


def fit(rows):
    """Least squares t_frame = eipf * (c1 + c2 * unaligned + c3 * rowdeg)
    over `rows`; fills predicted_gbps and residual_pct, returns (c1, c2,
    c3) in seconds per edge-iteration."""
    eipf = np.array([r["edge_iters_per_frame"] for r in rows])
    unal = np.array([0.0 if r["z_aligned"] else 1.0 for r in rows])
    rdeg = np.array([r["row_degree"] for r in rows])
    t = np.array([r["k"] / (r["measured_gbps"] * 1e9) for r in rows])
    A = np.stack([eipf, eipf * unal, eipf * rdeg], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    for r, pred_t in zip(rows, A @ coef):
        pred = r["k"] / pred_t / 1e9
        r["predicted_gbps"] = round(pred, 3)
        r["residual_pct"] = round((r["measured_gbps"] / pred - 1) * 100, 1)
    return coef


def slot_fit(rows):
    """(a, b, correlation, median |residual|) of ps/edge = a + b *
    bucket / rowdeg over the rows of a slot form (bucket > 0), or None
    when fewer than three rows have one."""
    rows = [r for r in rows if r["bucket"]]
    if len(rows) < 3:
        return None
    ps = np.array([r["ps_per_edge"] for r in rows])
    slots = np.array([r["bucket"] / r["row_degree"] for r in rows])
    A = np.stack([np.ones_like(slots), slots], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, ps, rcond=None)
    resid = np.abs(ps / (A @ (a, b)) - 1)
    return a, b, float(np.corrcoef(ps, slots)[0, 1]), float(np.median(resid))


def audit(cells):
    """(rows, {fit name: (coefficients, its rows)}) of a knob artifact's
    cells."""
    rows, fits = [], {}
    for name in sorted(cells):
        rec = cells[name]
        if not any(key in rec for key, *_ in FITS.values()):
            rows.append({"cell": name, "fit": "twophase", "note": rec.get(
                "skipped", rec.get("error", "no measured gbps"))})
            continue
        code = build_cell(name)
        lay = code.layout
        E = int(lay.E) * code.Z  # lifted edges
        for label, (key, sched, iters, two_phase) in FITS.items():
            if key not in rec:
                continue
            K, B = (rec["K"], rec["budget"]) if two_phase else (iters, 0)
            eipf = E * (K + (iters - K) * B / BATCH)
            meas = rec[key]
            rows.append({
                "cell": name, "n": code.n, "k": code.k,
                "E_lifted": E, "K": K, "budget": B,
                "z_aligned": code.Z % 8 == 0,
                "row_degree": round(int(lay.E) / lay.mb, 2),
                "edge_iters_per_frame": round(eipf, 1),
                "measured_gbps": meas,
                "ps_per_edge": round(
                    code.k / (meas * 1e9) / eipf * 1e12, 2),
                "fit": label, "bucket": bucket(code, sched, two_phase),
            })
    for label in FITS:
        ok = [r for r in rows if r.get("fit") == label and "k" in r]
        if ok:
            fits[label] = (fit(ok), ok)
    return rows, fits


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--knobs", default=KNOBS_ART)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    with open(args.knobs) as f:
        art = json.load(f)
    rows, fits = audit(art["cells"])
    tmp = args.out + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    os.replace(tmp, args.out)

    print(f"{args.knobs}: {art.get('device', 'TPU')}")
    for label, ((c1, c2, c3), ok) in fits.items():
        print(f"[{label}] fit: ps/edge = {1e12 * c1:.2f} + "
              f"{1e12 * c2:.2f}*[Z%8!=0] + {1e12 * c3:.3f}*rowdeg "
              f"({len(ok)} cells)")
        print(f"{'cell':<16}{'bucket':>7}{'meas':>8}{'pred':>8}"
              f"{'resid%':>8}{'ps/edge':>9}")
        for r in sorted(ok, key=lambda r: r["residual_pct"]):
            print(f"{r['cell']:<16}{r['bucket']:>7}{r['measured_gbps']:>8.3f}"
                  f"{r['predicted_gbps']:>8.3f}{r['residual_pct']:>8.1f}"
                  f"{r['ps_per_edge']:>9.2f}")
        resid = [abs(r["residual_pct"]) for r in ok]
        print(f"|residual|: median {np.median(resid):.1f}% "
              f"max {max(resid):.1f}% "
              f"({max(ok, key=lambda r: abs(r['residual_pct']))['cell']})")
        for b in sorted({r["bucket"] for r in ok}):
            ps = [r["ps_per_edge"] for r in ok if r["bucket"] == b]
            print(f"  bucket {b}: {len(ps)} cells, ps/edge median "
                  f"{np.median(ps):.2f} [{min(ps):.2f}, {max(ps):.2f}]")
        slots = slot_fit(ok)
        if slots:
            print(f"  slots: ps/edge = {slots[0]:.3f} + {slots[1]:.3f}"
                  f"*bucket/rowdeg, correlation {slots[2]:.3f}, median "
                  f"|residual| {100 * slots[3]:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
