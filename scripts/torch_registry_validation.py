"""Registry-wide validation of the flooding min-sum kernel (K1) on the H100,
the twin of scripts/registry_tpu_validation.py.  Imports only
tpu_ldpc_torch.

Per registry cell, K1 (csrc/bp_flood.cu, through build_cuda_decoder in
the code's own coordinates, as decode() runs it) and the port's plain
decoder (decode/reference.py) decode the same LLRs on the card, min-sum
alpha 0.75, 50 iterations, early termination on: bits, ok and iters_used
must be equal.  The FER of each cell goes into a CSV with its Wilson 95%
interval.

Cells and protocol are the TPU script's:

  * pass 1: the judged code, the 24 wifi / wimax cells and the 18 NR-like
    mothers (lifts 32 and 64) on the unpunctured channel, at Eb/N0 by
    rate;
  * pass 2: the 18 NR-like cells at their operating point, the first 2Z
    positions erased and Eb/N0 referenced to k / (n - 2Z);
  * 512-frame chunks, chunk c of a cell drawn from NumPy's
    default_rng(crc32("<cell>/<c>")): info bits, the generator encoder,
    BPSK and float64 noise rounded once to float32 -- the TPU script's
    streams, so the LLRs the Pallas kernel decoded there;
  * at least 4096 frames, then until 20 frame errors or 131072 frames;
  * the CSV rewritten atomically, one row a cell; a rerun skips a cell
    whose row is bit-exact and meets the stop rule at the same Eb/N0.

The plain decoder takes the chunks of a group (up to GROUP chunks) in one
call: frames decode independently, so that is the chunk-by-chunk result
at fewer launches.  Each row is also set beside the TPU script's row of
the same cell (same LLRs, so equal frames and FER when both kernels
decode as golden does) and the count of equal rows is printed.

    python scripts/torch_registry_validation.py
    python scripts/torch_registry_validation.py --max-chunks 1 \\
        --out-dir build/capped

writes artifacts/registry_h100_validation.csv and
artifacts/nr_operating_h100_validation.csv (or the same names under
--out-dir).  Exits 1 when a cell is not bit-exact.  --device cpu runs
the plain decoder in place of K1 (a rehearsal of the protocol only).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
ARTIFACTS = os.path.join(REPO, "artifacts")
OUT_NAMES = ("registry_h100_validation.csv",
             "nr_operating_h100_validation.csv")
TPU_ROWS = ("registry_tpu_validation.csv", "nr_operating_validation.csv")

# Eb/N0 by rate, near the min-sum-50 FER ~1e-2 point of the mid lifts
EBN0_BY_RATE = {"1/2": 1.8, "2/3": 2.4, "3/4": 2.8, "5/6": 3.6}

CHUNK = 512
MIN_FRAMES = 4096
MAX_FRAMES = 131072
TARGET_FE = 20
ITERS = 50
ALPHA = 0.75
GROUP = 8

FIELDS = ["cell", "n", "k", "Z", "rate", "ebn0_db", "frames", "fer",
          "fer_lo", "fer_hi", "bitexact", "mean_iters",
          "wall_ms_incl_compile", "ts"]


def cells():
    """(cell name, build_fn, rate label, Eb/N0) of pass 1."""
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    yield ("judged", LdpcCode.judged, "1/2", EBN0_BY_RATE["1/2"])
    for fam, lifts in (("wifi", (27, 54, 81)), ("wimax", (24, 48, 96))):
        for rate in ("1/2", "2/3", "3/4", "5/6"):
            for z in lifts:
                yield (f"{fam}_r{rate.replace('/', '')}_z{z}",
                       (lambda f=fam, r=rate, zz=z:
                        LdpcCode.from_family(f, r, zz)),
                       rate, EBN0_BY_RATE[rate])
    # the NR-like mothers on the unpunctured channel: the FER here is not
    # the family's operating curve (pass 2 is)
    nr_ebn0 = {"1/5": 1.2, "2/7": 1.5, "2/5": 2.0, "1/2": 1.8,
               "2/3": 2.4, "3/4": 2.8, "5/6": 3.6}
    for bg, rates in ((1, ("1/2", "2/3", "3/4", "5/6")),
                      (2, ("1/5", "2/7", "2/5", "1/2", "2/3"))):
        for z in (32, 64):
            for rate in rates:
                yield (f"nr{bg}_r{rate.replace('/', '')}_z{z}",
                       (lambda r=rate, b=bg, zz=z: nrlike_code(r, zz, bg=b)),
                       rate, nr_ebn0[rate])


def nr_operating_cells():
    """(cell name, build_fn, rate label, Eb/N0) of pass 2: the 18 NR-like
    cells at each family's waterfall point, +0.4 dB at Z=32."""
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    points = {(1, "1/2"): 1.6, (1, "2/3"): 2.4, (1, "3/4"): 2.8,
              (1, "5/6"): 3.4, (2, "1/5"): 1.0, (2, "2/7"): 1.3,
              (2, "2/5"): 1.7, (2, "1/2"): 2.0, (2, "2/3"): 2.6}
    for (bg, rate), ebn0 in points.items():
        for z, e in ((32, round(ebn0 + 0.4, 1)), (64, ebn0)):
            yield (f"nr{bg}_r{rate.replace('/', '')}_z{z}",
                   (lambda r=rate, b=bg, zz=z: nrlike_code(r, zz, bg=b)),
                   rate, e)


def chunk_llrs(cell, ci, code, sigma2, n_punct, device):
    """(u (CHUNK, k) uint8, llr (CHUNK, n) float32) of chunk ci of a cell,
    NumPy arrays; the codewords are encoded on `device`."""
    import torch

    from tpu_ldpc_torch.encode import encode

    rng = np.random.default_rng(zlib.crc32(f"{cell}/{ci}".encode()))
    u = rng.integers(0, 2, (CHUNK, code.k)).astype(np.uint8)
    c = encode(code, torch.from_numpy(u).to(device)).cpu().numpy()
    x = 1.0 - 2.0 * c.astype(np.float64)
    llr = ((2.0 / sigma2) * (x + np.sqrt(sigma2)
           * rng.normal(size=x.shape))).astype(np.float32)
    llr[:, :n_punct] = 0.0  # erased, never transmitted
    return u, llr


def load_rows(path):
    """The latest row of each cell in an existing CSV."""
    rows = {}
    if os.path.exists(path):
        with open(path) as f:
            for r in csv.DictReader(f):
                rows[r["cell"]] = r
    return rows


def write_atomic(rows, path, order):
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        for cell in order:
            if cell in rows:
                w.writerow(rows[cell])
        for cell, r in rows.items():  # cells of no pass, kept last
            if cell not in order:
                w.writerow(r)
    os.replace(tmp, path)


def done(prev, ebn0):
    """A recorded row that a fresh run would not change: bit-exact, at
    the same Eb/N0, and meeting the stop rule."""
    if not prev or prev["bitexact"] != "True":
        return False
    if abs(float(prev["ebn0_db"]) - ebn0) > 1e-9:
        return False
    frames = int(prev["frames"])
    fe = round(float(prev["fer"]) * frames)
    return frames >= MIN_FRAMES and (fe >= TARGET_FE
                                     or frames >= MAX_FRAMES)


def validate_cell(cell, code, ebn0, punctured, device, max_chunks=None):
    """Decode a cell's chunks with K1 and the plain decoder; returns
    (frames, frame errors, bit-exact, iteration sum)."""
    import torch

    from tpu_ldpc_torch.channel.awgn import noise_sigma2
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
    from tpu_ldpc_torch.decode.reference import build_decoder

    n_punct = 2 * code.Z if punctured else 0
    sigma2 = noise_sigma2(ebn0, code.k / (code.n - n_punct))
    kernel = build_cuda_decoder(code, "minsum", ITERS, ALPHA,
                                early_stop=True, normalize=False)
    plain = build_decoder(code, "minsum", ITERS, ALPHA, early_stop=True)
    max_chunks = max_chunks or MAX_FRAMES // CHUNK
    frames = fe = chunks = 0
    iters_sum = 0
    bitexact = True

    def more():
        return (chunks < max_chunks and frames < MAX_FRAMES
                and (fe < TARGET_FE or frames < MIN_FRAMES))

    while more():
        group = []
        while len(group) < GROUP and more():
            u, llr = chunk_llrs(cell, chunks, code, sigma2, n_punct, device)
            llr = torch.from_numpy(llr).to(device)
            out = kernel(llr)
            fe += int((out[0][:, :code.k].cpu().numpy() != u)
                      .any(axis=1).sum())
            iters_sum += int(out[2].sum())
            frames += CHUNK
            chunks += 1
            group.append((llr, out))
        want = plain(torch.cat([llr for llr, _ in group]))
        got = [torch.cat([out[i] for _, out in group]) for i in range(3)]
        bitexact &= all(torch.equal(g, w) for g, w in zip(got, want))
    return frames, fe, bitexact, iters_sum


def run_pass(work, out_path, punctured, device, max_chunks=None,
             tpu_path=None, log=print):
    """Validate the cells of `work` into `out_path`; returns (rows of this
    run, cells not bit-exact, cells whose frames and FER equal the TPU
    row, cells with a TPU row)."""
    from tpu_ldpc_torch.report.waterfall import wilson_interval

    rows = load_rows(out_path)
    tpu = load_rows(tpu_path) if tpu_path else {}
    order = [c for c, *_ in work]
    fresh, n_fail, n_same, n_tpu = {}, 0, 0, 0
    for cell, build_fn, rate_str, ebn0 in work:
        prev = rows.get(cell)
        if max_chunks is None and done(prev, ebn0):
            log(f"{cell}: already validated ({prev['frames']} frames), "
                "skip")
            continue
        code = build_fn()
        t0 = time.perf_counter()
        frames, fe, bitexact, iters_sum = validate_cell(
            cell, code, ebn0, punctured, device, max_chunks)
        # host wall time with the first build and the plain decodes: a
        # record of the run, never a throughput
        wall_ms = (time.perf_counter() - t0) * 1e3
        lo, hi = wilson_interval(fe, frames)
        rows[cell] = fresh[cell] = dict(
            cell=cell, n=code.n, k=code.k, Z=code.Z, rate=rate_str,
            ebn0_db=ebn0, frames=frames, fer=round(fe / frames, 6),
            fer_lo=round(lo, 6), fer_hi=round(hi, 6), bitexact=bitexact,
            mean_iters=round(iters_sum / frames, 2),
            wall_ms_incl_compile=round(wall_ms, 1),
            ts=time.strftime("%Y-%m-%d %H:%M"))
        write_atomic(rows, out_path, order)
        n_fail += not bitexact
        ref = tpu.get(cell)
        vs = ""
        if ref is not None and abs(float(ref["ebn0_db"]) - ebn0) < 1e-9:
            n_tpu += 1
            same = (int(ref["frames"]) == frames
                    and float(ref["fer"]) == rows[cell]["fer"])
            n_same += same
            vs = (f"; TPU row {ref['fer']} of {ref['frames']} "
                  f"({'equal' if same else 'differs'})")
        log(f"{cell}: bitexact={bitexact} fer={fe}/{frames} "
            f"[{lo:.4g},{hi:.4g}] mean_iters={rows[cell]['mean_iters']}"
            f"{vs}")
    return fresh, n_fail, n_same, n_tpu


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu decodes with the plain "
                        "decoder twice (protocol rehearsal)")
    p.add_argument("--max-chunks", type=int, default=None,
                   help="cap on the chunks of a cell (a capped run "
                        "re-validates every cell)")
    p.add_argument("--out-dir", default=ARTIFACTS)
    args = p.parse_args(argv)

    from tpu_ldpc_torch.codes_device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    n_fail = n_same = n_tpu = 0
    for work, name, tpu_name, punctured in (
            (list(cells()), OUT_NAMES[0], TPU_ROWS[0], False),
            (list(nr_operating_cells()), OUT_NAMES[1], TPU_ROWS[1], True)):
        _, fail, same, tpu = run_pass(
            work, os.path.join(args.out_dir, name), punctured, device,
            args.max_chunks,
            # a capped run's rows are thinner than the TPU rows
            None if args.max_chunks else os.path.join(ARTIFACTS, tpu_name),
            log=lambda s: print(s, flush=True))
        n_fail, n_same, n_tpu = n_fail + fail, n_same + same, n_tpu + tpu
    print(f"DONE n_fail={n_fail} equal_to_tpu_rows={n_same}/{n_tpu}",
          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
