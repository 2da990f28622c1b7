#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpu_ldpc_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA decode kernel from tpu_ldpc_torch/csrc with nvcc, holds it
bit for bit against its plain PyTorch version on the card, drives the
port's main path (the public decode(), run_ber and the sweep CLI on the
judged (1024, 512) code), times kernel and plain version with CUDA
events, and prints:

  - one line per phase;
  - {"kernels": [...]}: per kernel its launches on the main path, the
    largest |kernel - plain| seen (0: bit-exact) and both times;
  - last: {"ok": true, "device": {...}}.

Any failure raises (traceback, non-zero exit) and the last line is never
printed.  Without a CUDA device the script exits with 1 and prints no
result.  It imports only tpu_ldpc_torch and asserts that JAX never
loads.  The plain version is held bit for bit against the golden NumPy
model by the CPU tests, and the kernel against golden by the card tests
in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 20261016
REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
# frozen fixture row at 2.0 dB: tests/fixtures/judged_minsum50.csv
FIXTURE_CI_2DB = (9.276914e-03, 1.146777e-02)


def _noisy_llrs(code, batch, ebn0_db, seed):
    """(batch, n) float32 LLRs of random codewords, made with NumPy."""
    import numpy as np
    import torch

    from tpu_ldpc_torch.encode.encoder import build_encoder

    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = build_encoder(code, device="cpu")(torch.from_numpy(u)).numpy()
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def _special_llrs(llr, seed):
    """Noisy LLRs with exact +-0.0 and |LLR| >= 1e4 entries mixed in."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = llr.copy()
    r, c = out.shape
    pick = rng.random((r, c))
    out[pick < 0.02] = 0.0
    out[(pick >= 0.02) & (pick < 0.04)] = -0.0
    big = (pick >= 0.04) & (pick < 0.05)
    out[big] = np.where(llr[big] < 0, -3e4, 1e4)  # confident, same sign
    out[0, :] = 5.0          # all-zero codeword decision ...
    out[0, ::7] = -0.0       # ... with negative zeros: iters_used 0
    return out


def _wilson_interval(errors, trials, z=1.96):
    """Wilson score 95% interval of an error probability."""
    p = errors / trials
    denom = 1 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    half = z * math.sqrt(p * (1 - p) / trials
                         + z * z / (4 * trials * trials)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def _cuda_time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA "
              "device, nothing to test", file=sys.stderr)
        return 1
    import numpy as np

    from tpu_ldpc_torch import LdpcCode, _build
    from tpu_ldpc_torch.cli import sim as cli_sim
    from tpu_ldpc_torch.decode import decode
    from tpu_ldpc_torch.decode.cuda_bp import minsum_flood
    from tpu_ldpc_torch.decode.reference import build_decoder
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step, run_ber

    # ---- 1. device --------------------------------------------------------
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {name} capability={cap} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"[1 device] nvidia-smi: {smi}")
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a, card is sm_{cap}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] {_build.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2 build] ptxas: {line.strip()}")

    # ---- 3. kernel vs plain on the card ------------------------------------
    judged = LdpcCode.judged()
    cases = [  # (code, Eb/N0 in its waterfall, batches)
        (judged, 2.0, (4096, 4097)),
        (LdpcCode.from_family("wifi", "2/3", 27), 2.0, (4096,)),   # odd Z
        (LdpcCode.from_family("wimax", "5/6", 96), 3.0, (4096,)),  # row deg 19
    ]
    max_abs_err = 0
    for ci, (code, ebn0, batches) in enumerate(cases):
        base = _noisy_llrs(code, max(batches), ebn0, SEED + ci)
        inputs = [(f"{ebn0} dB b={b}", base[:b]) for b in batches]
        inputs.append(("+-0.0/1e4 b=1024", _special_llrs(base[:1024], SEED)))
        for label, llr_np in inputs:
            llr = torch.from_numpy(np.ascontiguousarray(llr_np)).to(dev)
            for et in (True, False):
                kb, kok, kiu = minsum_flood(code, llr, 50, 0.75, 0.0, et)
                plain = build_decoder(code, "minsum", 50, 0.75, 0.0,
                                      "flooding", et)
                pb, pok, piu = plain(llr)
                torch.cuda.synchronize()
                err = max(
                    int((kb.int() - pb.int()).abs().max()),
                    int((kok.int() - pok.int()).abs().max()),
                    int((kiu - piu).abs().max()),
                )
                max_abs_err = max(max_abs_err, err)
                if err:
                    raise AssertionError(
                        f"{code.name} {label} et={et}: kernel != plain "
                        f"(max |diff| {err})")
                print(f"[3 kernel==plain] {code.name} {label} "
                      f"et={et}: bit-exact, ok={float(kok.float().mean()):.4f} "
                      f"mean_iters={float(kiu.double().mean()):.3f}")

    # ---- 4. main path -----------------------------------------------------
    os.makedirs(OUT_DIR, exist_ok=True)
    llr_np = _noisy_llrs(judged, 4096, 2.0, SEED + 10)
    llr = torch.from_numpy(llr_np).to(dev)
    minsum_flood.launches = 0
    bits, ok, iters_used = decode(judged, llr)
    torch.cuda.synchronize()
    if minsum_flood.launches < 1:
        raise AssertionError("decode() did not launch the kernel")
    if not (bits.shape == (4096, judged.n) and bits.dtype == torch.uint8
            and ok.shape == (4096,) and iters_used.dtype == torch.int32):
        raise AssertionError("decode() output shapes / dtypes")
    pb, pok, piu = decode(judged, llr[:256].cpu())  # the plain version
    if not (torch.equal(bits[:256].cpu(), pb)
            and torch.equal(ok[:256].cpu(), pok)
            and torch.equal(iters_used[:256].cpu(), piu)):
        raise AssertionError("decode() on the card != decode() on the CPU "
                             "(256 rows)")
    print(f"[4 decode] judged b=4096 ok={float(ok.float().mean()):.4f} "
          f"launches={minsum_flood.launches}")

    t0 = time.perf_counter()
    res = run_ber(judged, [2.0], DecodeCfg(), batch=4096,
                  target_frame_errors=10**9, max_frames=65536, device="cuda")[0]
    wall = time.perf_counter() - t0
    lo, hi = _wilson_interval(res.frame_errors, res.frames)
    print(f"[4 run_ber] judged 2.0 dB frames={res.frames} "
          f"frame_errors={res.frame_errors} FER={res.fer:.4e} "
          f"CI95=[{lo:.4e}, {hi:.4e}] mean_iters={res.mean_iters:.3f} "
          f"undetected={res.undetected} wall={wall:.2f} s")
    if res.frames != 65536:
        raise AssertionError(f"run_ber ran {res.frames} frames, not 65536")
    if not (lo <= FIXTURE_CI_2DB[1] and FIXTURE_CI_2DB[0] <= hi):
        raise AssertionError(
            f"FER CI [{lo:.4e}, {hi:.4e}] misses the fixture's {FIXTURE_CI_2DB}")

    step1 = build_mc_step(judged, DecodeCfg(), 4096, 1, device="cuda")
    step4 = build_mc_step(judged, DecodeCfg(), 4096, 4, device="cuda")
    c1 = sum(np.asarray(step1(0, 0, 2.0, t).tolist()) for t in range(4))
    c4 = np.asarray(step4(0, 0, 2.0, 0).tolist())
    if not np.array_equal(c1, c4):
        raise AssertionError(f"steps_per_call 1 vs 4: {c1} != {c4}")
    print(f"[4 regroup] steps_per_call 1 == 4 over 4 batches: {c4.tolist()}")

    csv = os.path.join(OUT_DIR, "judged_2db.csv")
    cli_sim.main(["--family", "judged", "--ebn0", "2.0", "--device", "cuda",
                  "--batch", "2048", "--max-frames", "16384", "--csv", csv])
    with open(csv) as f:
        row = f.read().strip().splitlines()[-1].split(",")
    if int(row[1]) < 16384:
        raise AssertionError(f"CLI CSV row {row}")
    print(f"[4 cli] wrote {csv}: frames={row[1]} FER={row[7]}")
    main_path_launches = minsum_flood.launches
    if main_path_launches < 1:
        raise AssertionError("the main path launched the kernel no time")
    print(f"[4 main path] minsum_flood launches={main_path_launches}")

    # ---- 5. times (CUDA events, after warm-up) ----------------------------
    plain_off = build_decoder(judged, "minsum", 50, 0.75, 0.0, "flooding",
                              False)

    def kernel_off():
        minsum_flood(judged, llr, 50, 0.75, 0.0, early_stop=False)

    def plain():
        plain_off(llr)

    def kernel_on():
        minsum_flood(judged, llr, 50, 0.75, 0.0, early_stop=True)

    for fn in (kernel_off, plain, kernel_on):
        fn()
    torch.cuda.synchronize()
    # plain, kernel, kernel, plain: both see the same card state
    p1 = _cuda_time_ms(plain, 20)
    k1 = _cuda_time_ms(kernel_off, 20)
    k2 = _cuda_time_ms(kernel_off, 20)
    p2 = _cuda_time_ms(plain, 20)
    k_on = _cuda_time_ms(kernel_on, 20)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    info_bits = 4096 * judged.k
    print(f"[5 time] judged b=4096 50 it ET off: kernel {k_ms:.4f} ms/batch "
          f"({k1:.4f}, {k2:.4f}) = {info_bits / k_ms * 1e3:.4e} info bit/s; "
          f"plain {p_ms:.4f} ms/batch ({p1:.4f}, {p2:.4f}) = "
          f"{info_bits / p_ms * 1e3:.4e} info bit/s")
    print(f"[5 time] judged b=4096 2.0 dB ET on: kernel {k_on:.4f} ms/batch "
          f"= {info_bits / k_on * 1e3:.4e} info bit/s")
    step1(0, 0, 2.0, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(10):
        step1(0, 0, 2.0, t)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"[5 time] MC step judged b=4096 2.0 dB (draw, encode, channel, "
          f"decode ET on, counters): {step_ms:.4f} ms host clock "
          f"= {info_bits / step_ms * 1e3:.4e} info bit/s")

    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    print(json.dumps({"kernels": [{
        "name": "minsum_flood",
        "route": "cuda",
        "source": "tpu_ldpc_torch/csrc/minsum_flood.cu",
        "replaces": "tpu_ldpc/decode/pallas_bp.py:514",
        "launches": main_path_launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
