#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpu_ldpc_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA decode kernels from tpu_ldpc_torch/csrc with nvcc (one
nvcc per source, in parallel), holds each against its plain PyTorch
version on the card (min-sum, sumproduct-fast and fixed-point min-sum bit
for bit, exact sum-product frame by frame), drives the port's main paths
on the judged (1024, 512) code through the public entry points -- slice
1: flooding min-sum decode(), run_ber and the sweep CLI; slice 2: layered
min-sum and exact sum-product through decode() and run_ber; slice 3:
sumproduct-fast and fixed-point min-sum through decode(), run_ber against
the frozen quantized rows and the CLI's Eb/N0-at-FER search; slice 4:
build_cuda_decoder's storage and arithmetic modes (compressed row state,
bf16 messages, rescaled min-sum, shift normalization) against the
float32 decoder and decode() in the code's own coordinates; slice 5: the
redesigned flooding body on one code per row-degree bucket (and its
two-pass form), with ptxas's registers and spills of every instantiation;
slice 6: the redesigned layered body and compressed-state kernel (K6) on
one code per bucket and their two-pass and walking forms, K6 against the
float32 K1, no spill in any judged-code instantiation; slice 7: the
rate-compatible path (K1 and K2 on the punctured NR-like mothers, the
dual-diagonal encoder on every registry cell, run_ber against the NR
rows and both arms of the frozen CRC run, IR-HARQ against its plain run
and the JAX run's stages, the CLI with --family nr --crc); slice 8: the
hard-decision and windowed decoders against their CPU runs; slice 9:
code construction and analysis (the trapping-set census of the
punctured NR mother on K1 against its frozen TPU-run row, the impulse
d_min probe on K3, the construction CLI with the g++-built native helper,
a family cell without a committed table); slice 10: distribution
(run_ber and the grid sweep over a world-1 NCCL mesh against the
single-device counters, two gloo ranks sharing the card against the
replay of their streams, the ring and partitioned decoders against the
plain decoder, build_decode_fn's routing, the torchrun launcher against
the single-process CLI, --profile); slice 11: the throughput CLI
(tpu_ldpc_torch.cli.bench.main in this process: the headline, layered,
ET on, sumproduct-fast and the headline under --profile, its time
against phase 5's K1 time) and the registry validation capped at one
chunk a cell; slice 12: the registry tools (the registry timing script's
measurement of four cells, the judged ET-off times against phase 5's,
measure_at over buffers rebuilt on the card against measure, the
edge-rate audit over those rows, one IR-HARQ point with its stage times
and delivered Gb/s); the MC batch kernels (mc_encode_llr,
mc_count) against BatchFn's torch ops bit for bit, at the cells' shapes
too, the regroup identity and the world-1 sharded step; K1g, the flooding
kernel's device-memory form, at the Z = 384 MC cell's shape through the
MC step, build_decode_fn and decode() against the plain decoder bit for
bit -- times kernels and plain versions with CUDA events, and prints:

  - one line per phase, and each [slice11] and [slice12] record;
  - the card's name and power limit (nvidia-smi);
  - {"kernels": [...]}: per kernel its launches on the main paths, the
    largest |kernel - plain| seen (0: bit-exact) and, for sum-product,
    the share of frames that agree, its time, the plain version's time
    and the least time the card could take (bound_ms);
  - last: {"ok": true, "device": {...}}.

Any failure raises (traceback, non-zero exit) and the last line is never
printed.  Without a CUDA device the script exits with 1 and prints no
result.  It imports only tpu_ldpc_torch and asserts that JAX never
loads.  The plain versions are held against the golden NumPy model by
the CPU tests, and the kernels against golden by the card tests in
tests/test_torch_cuda.py.
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
BATCH = 4096
# Wilson 95% intervals at 2.0 dB that run_ber's interval must overlap:
# the frozen rows of tests/fixtures/judged_minsum50.csv (flooding
# min-sum, 50 it) and artifacts/judged_layered25.csv (layered min-sum,
# 25 it); for flooding exact sum-product (50 it) the JAX package's jnp
# reference run on the CPU (tests/test_torch_sp_reference.py), because
# the frozen artifacts/judged_sumproduct50.csv row, written by the Pallas
# kernel on a TPU, lies above that reference's interval
FROZEN_CI_2DB = {
    "minsum flooding 50": (9.276914e-03, 1.146777e-02),
    "minsum layered 25": (9.103468e-03, 1.127505e-02),
    "sumproduct flooding 50": (2.999297e-03, 3.894854e-03),
}
TPU_SP_ROW_2DB = (4.074653e-03, 5.108183e-03)
# fixed-point min-sum (flooding, 50 it) at 2.0 dB: (frame errors, frames)
# of the frozen rows of artifacts/judged_quant_minsum50.csv (the JAX
# package's jnp reference on the CPU); run_ber's Wilson interval over
# `frames` frames must overlap the row's
QUANT_ROWS_2DB = {  # label: (quant_bits, quant_step, errors, frames, run)
    "q6_s0.25": (6, 0.25, 63, 4096, 65536),
    "q4_s0.5": (4, 0.5, 226, 512, 16384),
}
# Eb/N0 at FER 1e-2 (judged, flooding, 50 it) from
# artifacts/spfast_vs_sp_fer.json (jnp on the CPU, sim/search.py):
# sumproduct-fast must land within SPFAST_BAND_DB of its value; min-sum's
# lies outside that band
SPFAST_AT_FER_DB = 1.8770
SP_AT_FER_DB = 1.8418
MINSUM_AT_FER_DB = 2.0293
SPFAST_BAND_DB = 0.08
# exact sum-product, kernel against plain version on the same card: the
# share of frames whose bits, ok and iters_used all agree.  Both agreed on
# every frame at 2.0 dB on an H100; 0.999 leaves room for a rounding
# split in 4 frames of 4096 and no more.  1.0 dB is where most frames
# fail and run every iteration, so a wrong check-node update shows there.
# Min-sum in place of sum-product must fall below the bar (a control).
SP_MIN_AGREEMENT = 0.999
SP_EBN0 = (2.0, 1.0)
# slice 7: the NR-like mothers with their two high-degree blocks
# punctured (codes/nrlike.py::nrlike_adapt), flooding min-sum 50 it, the
# frozen rows the JAX package wrote: artifacts/nr1_r12_z64_minsum50.csv
# and artifacts/nr2_r15_z64_minsum50.csv, (Eb/N0, frames, Wilson 95%)
NR_ROWS = {  # (family, rate): ...
    ("nr", "1/2"): (1.6, 65536, (1.768744e-03, 2.470534e-03)),
    ("nr2", "1/5"): (1.0, 32768, (1.206263e-02, 1.454074e-02)),
}
# artifacts/crc_undetected.json: nr2_r15_z64 punctured, 50 it, 1.2 dB,
# 262,144 frames an arm, seed 7: arm -> (FER, undetected); the crc24 arm
# must stay at <= 1 undetected, the syndrome arm (the control) at >= 1
CRC_EBN0, CRC_FRAMES, CRC_SEED = 1.2, 262144, 7
CRC_ARMS = {"syndrome": (0.003482818603515625, 17),
            "crc24": (0.010097503662109375, 0)}
# artifacts/nr1_irharq.json (JAX, Z=64, b=4096, seed 0, crc24): per
# ladder (bg, Eb/N0, stage m -> fer_after of that run)
HARQ_LADDERS = (
    (1, 2.0, {7: 0.998046875, 10: 0.2109375, 13: 0.000244140625, 24: 0.0}),
    (2, 1.5, {7: 0.991455078125, 12: 0.00048828125, 17: 0.0, 27: 0.0,
              42: 0.0}),
)
# slice 8: the hard decoders on the judged code (50 it) are held against
# their CPU run on the first HARD_CPU_ROWS frames (frames decode
# independently); the windowed decoder on sc_l32_z64, W=8, 3 iterations
# per window, min-sum at 2.5 dB over 16384 frames against the frozen
# rows of artifacts/tpu_windowed_point.json (the JAX decoder's results,
# 16384 frames: every flooding value there is a multiple of 1/16384):
# frame errors of the flooding sweep (fer_vs_snr.windowed_W8_ipw3["2.5"]
# = 0.0640869140625 = 1050/16384) and of the layered sweep
# (layered_sweep_r5.fer_vs_snr.W8_ipw3["2.5"] = 0.02454, four digits:
# 402.06 of 16384)
HARD_CPU_ROWS = 1024
SC_BATCH = 1024
WINDOWED_EBN0, WINDOWED_FRAMES = 2.5, 16384
WINDOWED_ROWS = {"flooding": 1050, "layered": 402}
# slice 9: the trapping-set census at the first point of
# scripts/trapping_census.py (nr2_r15_z64, first 2Z erased, flooding
# min-sum 50 it, alpha 0.75, chunks of 2048 paired-seed frames, until 150
# info-wrong failures or 2^19 frames), held by Wilson interval against
# that point of artifacts/nr2_trapping_census.json (a decoding result);
# the impulse d_min probe on the judged code (4 gammas, 512 pairs, 60 it
# exact sum-product: 5120 frames) and on tests/test_dmin.py's toy code,
# whose d_min is 4; the construction CLI and one family cell without a
# committed table
CENSUS_JSON = os.path.join(REPO, "artifacts", "nr2_trapping_census.json")
CENSUS_EBN0, CENSUS_TARGET, CENSUS_MAX_FRAMES = 1.2, 150, 1 << 19
CENSUS_KW = dict(iters=50, alpha=0.75, chunk=2048)
TOY_DMIN = 4
CODEGEN_ARGV = ["--family", "custom", "--mb", "4", "--nb", "8", "--z", "16",
                "--pexit", "15", "--anneal", "200", "--ace", "--threshold",
                "--dmin", "20"]
NEW_CELL = ("wimax", "3/4", 32)
# slice 11: the throughput CLI (tpu_ldpc_torch.cli.bench.main, in this
# process) on the judged code at b=BATCH: (label, flags, the kernels its
# decodes launch); (e) is (a) under --profile.  (a)'s ms_per_batch must
# lie within BENCH_K1_BAND of phase 5's K1 time (CUDA events, same run)
SLICE11_BENCH = (
    ("a", [], {"minsum_flood"}),
    ("b", ["--schedule", "layered", "--iters", "25"], {"minsum_layered"}),
    ("c", ["--early-stop"], {"minsum_flood"}),
    ("d", ["--algo", "sumproduct-fast"], {"spfast_flood"}),
    ("e", [], {"minsum_flood"}),
)
BENCH_KEYS = {"code", "n", "k", "ebn0_db", "algo", "iters", "schedule",
              "early_stop", "batch", "backend", "n_devices", "ms_per_batch",
              "info_bits_per_s", "gbps", "device_kind"}
BENCH_K1_BAND = 0.10
REGISTRY_SCRIPT = os.path.join(REPO, "scripts",
                               "torch_registry_validation.py")
# slice 12: the registry tools (scripts/torch_tune_registry_knobs.py,
# torch_roofline_audit.py, torch_irharq.py) in this process on four cells
# of the tuner (the judged code; Z not a multiple of 8 with rows of degree
# ~20; a wimax lift; the flooding two-pass form) and one HARQ point.  The
# judged code's layered-25 and flooding-50 ET-off times must lie within
# SLICE12_BAND of phase 5's K2 and K1 times, and measure_at at a timer's
# own point, its buffers rebuilt after another point's, within
# SLICE12_BAND of measure.
SLICE12_CELLS = ("qc1024_r12", "wifi_r56_z81", "wimax_r12_z96",
                 "nr1_r12_z64")
SLICE12_REPS = 20
SLICE12_HARQ = (1, 3.0)  # (ladder, Eb/N0)
SLICE12_BAND = 0.10
# the least time the card could take: device memory 3.35 TB/s, FP32
# outside the tensor cores 67 TFLOP/s (H100 SXM datasheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# floating-point operations per edge and iteration that the algorithm
# needs, counting tanh and log as one operation each, one compare for a
# scan that tests its largest kept value first, and sign and index
# selects as free: min-sum q = p - R, |q|, the min compare,
# max(m - beta, 0), alpha *, sign *, the VN add; sum-product q, |q|, phi
# (clip 2, * 0.5, tanh, log, negate) twice, the phi sum, tot - phi_e, two
# sign products, the VN add; sumproduct-fast q, |q|, the compare of the
# three-smallest scan, sign *, the VN add, plus per check row three
# f-pairs of 25 each (a + b, a - b, |.|, two ctilde of 3 products, 3
# differences and 3 maxima, the min, d1 - d2, the add, the max);
# fixed-point min-sum adds to min-sum the message clip (2) and the output
# quantizer on the magnitude (/ step, + 0.5, floor, min, * step, the zero
# select: 6), the sign already counted.  The channel quantizer and the
# posterior clip, per variable, are left out.
# rescaled min-sum (K8) sends the exclusive minimum itself (alpha 1, beta
# 0): q, |q|, the compare, sign *, the VN add, plus one multiply of the
# channel term per variable and iteration; compressed state (K6) scales
# the two minima once per check row (max(m - beta, 0) and alpha * on
# each: 4) and per edge does q, |q|, the compare, the VN add and the sign
# of the message it rebuilds in each of its two passes (6); bf16 storage
# (K7) and normalized coordinates (K9) count as their CN update
# (conversions are loads and stores, indices are free).
OPS_PER_EDGE_ITER = {"minsum": 7, "sumproduct": 19, "sumproduct-fast": 5,
                     "minsum-quant": 15, "minsum-rescaled": 5,
                     "minsum-compressed": 6}
OPS_PER_ROW_ITER = {"sumproduct-fast": 75, "minsum-compressed": 4}
OPS_PER_VAR_ITER = {"minsum-rescaled": 1}
Q6 = {"quant_bits": 6, "quant_step": 0.25}
PLAIN = {"normalize": False}  # K1-K5 are timed in the code's coordinates
BF16 = {"msg_dtype": "bf16"}  # torch.bfloat16, set in main()
SRC = "tpu_ldpc_torch/csrc/"
PALLAS = "tpu_ldpc/decode/pallas_bp.py:"
# (name, algo, schedule, main-path iterations, source, TPU kernel it
# replaces, build_cuda_decoder mode of the timed and phase-3 runs)
KERNELS = (
    ("minsum_flood", "minsum", "flooding", 50, SRC + "bp_flood.cu",
     PALLAS + "514", PLAIN),
    ("minsum_layered", "minsum", "layered", 25, SRC + "bp_layered.cu",
     PALLAS + "609", PLAIN),
    ("sumproduct_flood", "sumproduct", "flooding", 50, SRC + "bp_flood.cu",
     PALLAS + "306", PLAIN),
    ("sumproduct_layered", "sumproduct", "layered", 25,
     SRC + "bp_layered.cu", PALLAS + "306", PLAIN),
    ("spfast_flood", "sumproduct-fast", "flooding", 50, SRC + "bp_flood.cu",
     PALLAS + "259", PLAIN),
    ("spfast_layered", "sumproduct-fast", "layered", 25,
     SRC + "bp_layered.cu", PALLAS + "259", PLAIN),
    ("minsum_quant_flood", "minsum", "flooding", 50, SRC + "bp_flood.cu",
     PALLAS + "459", {**PLAIN, **Q6}),
    ("minsum_quant_layered", "minsum", "layered", 25, SRC + "bp_layered.cu",
     PALLAS + "459", {**PLAIN, **Q6}),
    # slice 4
    ("minsum_compressed_flood", "minsum", "flooding", 50,
     SRC + "bp_compressed.cu", PALLAS + "709", {"compressed": True}),
    ("minsum_flood_bf16", "minsum", "flooding", 50, SRC + "bp_flood.cu",
     PALLAS + "487", {**PLAIN, **BF16}),
    ("minsum_layered_bf16", "minsum", "layered", 25, SRC + "bp_layered.cu",
     PALLAS + "487", {**PLAIN, **BF16}),
    ("sumproduct_flood_bf16", "sumproduct", "flooding", 50,
     SRC + "bp_flood.cu", PALLAS + "487", {**PLAIN, **BF16}),
    ("sumproduct_layered_bf16", "sumproduct", "layered", 25,
     SRC + "bp_layered.cu", PALLAS + "487", {**PLAIN, **BF16}),
    ("spfast_flood_bf16", "sumproduct-fast", "flooding", 50,
     SRC + "bp_flood.cu", PALLAS + "487", {**PLAIN, **BF16}),
    ("spfast_layered_bf16", "sumproduct-fast", "layered", 25,
     SRC + "bp_layered.cu", PALLAS + "487", {**PLAIN, **BF16}),
    ("minsum_rescaled_flood", "minsum", "flooding", 50, SRC + "bp_flood.cu",
     PALLAS + "443", {**PLAIN, "rescaled": True}),
    ("minsum_flood_normalized", "minsum", "flooding", 50,
     SRC + "bp_flood.cu", PALLAS + "108", {"normalize": True}),
    ("minsum_layered_normalized", "minsum", "layered", 25,
     SRC + "bp_layered.cu", PALLAS + "108", {"normalize": True}),
)


def _kind(algo, mode):
    """The OPS_PER_EDGE_ITER key of a kernel."""
    for key in ("quant_bits", "rescaled", "compressed"):
        if mode.get(key):
            return "minsum-" + key.split("_")[0]
    return algo


def _ptxas_report(log):
    """[(mangled kernel name, registers, spill bytes stored + loaded)]
    from nvcc -Xptxas -v output."""
    import re

    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def _instantiation(mangled):
    """A readable name for a kernel instantiation: bp_flood_kernel's and
    bp_layered_kernel's CN update, quantization, message storage, (flood)
    rescaled flag and kMaxDeg; bp_compressed_kernel's form; other names
    stay mangled."""
    import re

    m = re.search(r"bp_compressed_kernelILb([01])E", mangled)
    if m:
        return f"bp_compressed_kernel<kOneCheck={m.group(1)}>"
    kind = next((k for k in ("bp_flood_kernel", "bp_layered_kernel")
                 if k in mangled), None)
    if kind is None:
        return mangled
    parts = [re.search(pat, mangled).group(1) for pat in (
        r"\d(MinSumUnit|MinSum|SumProductFast|SumProduct)E",
        r"\d(NoQuant|Quant)E", r"\d(F32Msg|Bf16Msg)E")]
    if kind == "bp_flood_kernel":
        rescaled, max_deg = re.search(r"Lb([01])ELi(\d+)E",
                                      mangled).groups()
        parts.append(f"rescaled={rescaled}")
    else:
        max_deg = re.search(r"Li(\d+)E", mangled).group(1)
    return f"{kind}<{', '.join(parts)}, kMaxDeg={max_deg}>"


# the judged code's instantiations, which must not spill: (pattern of
# _instantiation's name, how many the sources have)
JUDGED_INSTANTIATIONS = (
    ("bp_flood_kernel<", "kMaxDeg=8>", 8),
    ("bp_layered_kernel<", "kMaxDeg=8>", 7),
    ("bp_compressed_kernel<kOneCheck=1>", "", 1),
)


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


def _punctured_llrs(code, batch, ebn0_db, seed):
    """(batch, n) float32 CPU LLRs of random codewords of an NR-like code
    with its family's puncturing: +0.0 on the two high-degree blocks,
    Eb/N0 referenced to the transmitted rate."""
    import numpy as np
    import torch

    from tpu_ldpc_torch.channel.adapt import adapted_llrs_from_noise
    from tpu_ldpc_torch.codes.nrlike import nrlike_adapt
    from tpu_ldpc_torch.encode.encoder import build_encoder

    adapt = nrlike_adapt(code)
    tx, known, _ = (torch.from_numpy(a) for a in adapt.masks(code.n, code.k))
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = build_encoder(code, device="cpu")(torch.from_numpy(u))
    noise = torch.from_numpy(rng.standard_normal((batch, code.n),
                                                 dtype=np.float32))
    return adapted_llrs_from_noise(c, noise, ebn0_db,
                                   adapt.rate(code.n, code.k), tx, known)


def _bsc_llrs(code, batch, p, seed):
    """(LLRs, codewords) of random codewords over a BSC(p), NumPy draws."""
    import numpy as np
    import torch

    from tpu_ldpc_torch.channel.bsc import bsc_llrs_from_flips
    from tpu_ldpc_torch.encode.encoder import build_encoder

    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = build_encoder(code, device="cpu")(torch.from_numpy(u))
    flips = torch.from_numpy(rng.random(c.shape) < p)
    return bsc_llrs_from_flips(c, flips, p), c


def _zero_codeword_llrs(code, batch, ebn0_db, seed):
    """(batch, n) float32 CPU LLRs of the all-zero codeword (an SC chain's
    H is rank-deficient), Eb/N0 referenced to the design rate."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = 1.0 + np.sqrt(sigma2) * rng.normal(size=(batch, code.n))
    return torch.from_numpy((2.0 / sigma2 * y).astype(np.float32))


def _device_events(fn):
    """(device events (kernels, copies, fills), their summed duration in
    ms) of one call of fn, by torch.profiler; (0, 0.0) when the profiler
    sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(spans), sum(spans) / 1e3


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


def _diff(got, want):
    """(largest |kernel - plain| over bits, ok and iters_used, share of
    frames whose bits, ok and iters_used all agree)."""
    gb, gok, giu = got
    wb, wok, wiu = want
    err = max(int((gb.int() - wb.int()).abs().max()),
              int((gok.int() - wok.int()).abs().max()),
              int((giu - wiu).abs().max()))
    same = (gb == wb).all(dim=1) & (gok == wok) & (giu == wiu)
    return err, float(same.double().mean())


def _bound_ms(code, batch, kind, iters_executed):
    """The least time of one decode: device-memory bytes (LLRs in, bits,
    ok and iters_used out, each once) over 3.35 TB/s, or the operations
    the codewords' iterations need over 67 TFLOP/s, whichever is larger.
    kind: a key of OPS_PER_EDGE_ITER.  Returns (ms, 'bytes' or
    'operations')."""
    nbytes = batch * code.n * 4 + batch * code.n + batch + batch * 4
    ops = ((OPS_PER_EDGE_ITER[kind] * code.layout.E * code.Z
            + OPS_PER_ROW_ITER.get(kind, 0) * code.m
            + OPS_PER_VAR_ITER.get(kind, 0) * code.n)
           * float(iters_executed))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _run_ber_check(run_ber, code, cfg, label, seed, frames=65536, ref=None,
                   ebn0=2.0, batch=None, **kw):
    """run_ber over `frames` frames at `ebn0` dB (`kw`: adapt, crc); its
    Wilson interval must overlap the frozen row's (`ref`, else
    FROZEN_CI_2DB[label]).  batch: None makes `frames` 8 batches (run_ber
    syncs every 8 batches on the card).  Returns the SnrResult."""
    t0 = time.perf_counter()
    res = run_ber(code, [ebn0], cfg, batch=batch or min(BATCH, frames // 8),
                  target_frame_errors=10**9, max_frames=frames, seed=seed,
                  device="cuda", **kw)[0]
    wall = time.perf_counter() - t0
    lo, hi = _wilson_interval(res.frame_errors, res.frames)
    ref = FROZEN_CI_2DB[label] if ref is None else ref
    print(f"[4 run_ber] {code.name.replace('qc1024_r12', 'judged')} "
          f"{label} {ebn0} dB frames={res.frames} "
          f"frame_errors={res.frame_errors} FER={res.fer:.4e} "
          f"CI95=[{lo:.4e}, {hi:.4e}] reference={ref} "
          f"mean_iters={res.mean_iters:.3f} detected={res.detected} "
          f"undetected={res.undetected} wall={wall:.2f} s")
    if res.frames != frames:
        raise AssertionError(f"run_ber ran {res.frames} frames, not "
                             f"{frames}")
    if label.startswith("sumproduct"):
        print(f"[4 run_ber] {label}: the TPU row of "
              f"artifacts/judged_sumproduct50.csv is {TPU_SP_ROW_2DB}; "
              f"overlap {lo <= TPU_SP_ROW_2DB[1] and TPU_SP_ROW_2DB[0] <= hi}")
    if not (lo <= ref[1] and ref[0] <= hi):
        raise AssertionError(
            f"{label}: FER CI [{lo:.4e}, {hi:.4e}] misses {ref}")
    return res


def _slice8_path(dev, kernel, cli_main):
    """The hard-decision and windowed decoders through decode(), run_ber
    and the CLI: bitflip and WBF on the judged code (AWGN 4.0 dB and BSC
    p=0.002, b=4096, 50 it), the card against the CPU bit for bit, bitflip
    over the BSC decoding >= 0.9 of frames; the windowed decoder on
    sc_l32_z64 (W=8, 3 iterations per window, b=1024, both sweeps), the
    card against the CPU (min-sum and sumproduct-fast bit for bit, exact
    sum-product on >= SP_MIN_AGREEMENT of 256 frames), its full-window
    pins against K1 / K2 (kernel(kname, code, iters, early_stop), as
    main() builds them), run_ber against the frozen 16384-frame rows;
    the README's windowed CLI example and the bitflip CLI."""
    import contextlib
    import io

    import torch

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
    from tpu_ldpc_torch.decode import decode
    from tpu_ldpc_torch.decode.hard import build_hard_decoder
    from tpu_ldpc_torch.decode.windowed import build_windowed_decoder
    from tpu_ldpc_torch.sim.mc import DecodeCfg, run_ber

    judged = LdpcCode.judged()
    awgn = torch.from_numpy(_noisy_llrs(judged, BATCH, 4.0, SEED + 50))
    bsc, sent = _bsc_llrs(judged, BATCH, 0.002, SEED + 51)
    rows = slice(0, HARD_CPU_ROWS)
    for label, llr in (("AWGN 4.0 dB", awgn), ("BSC p=0.002", bsc)):
        for algo in ("bitflip", "wbf"):
            got = [x.cpu() for x in decode(judged, llr.to(dev), algo=algo,
                                           iters=50)]
            want = build_hard_decoder(judged, algo, 50, device="cpu")(
                llr[rows])
            err, _ = _diff([x[rows] for x in got], want)
            what = (f"{algo} judged {label} b={llr.shape[0]} 50 it: "
                    f"ok={float(got[1].double().mean()):.4f} "
                    f"mean_iters={float(got[2].double().mean()):.3f}")
            if label.startswith("BSC"):
                right = float((got[0] == sent).all(dim=1).double().mean())
                what += f" frames decoded={right:.4f}"
                if algo == "bitflip" and right < 0.9:
                    raise AssertionError(f"{what}: bitflip over the BSC "
                                         "decoded < 0.9 of frames")
            if err:
                raise AssertionError(f"{what}: card != CPU on the first "
                                     f"{HARD_CPU_ROWS} frames")
            print(f"[4 hard] {what}; card == CPU bit for bit on the first "
                  f"{HARD_CPU_ROWS} frames")

    sc = LdpcCode.from_base_graph(make_sc_base_graph(32, 64), 64,
                                  "sc_l32_z64")
    llr = _zero_codeword_llrs(sc, SC_BATCH, 2.0, SEED + 52)
    for sweep in ("flooding", "layered"):
        for algo, batch in (("minsum", SC_BATCH),
                            ("sumproduct-fast", SC_BATCH),
                            ("sumproduct", 256)):
            got = [x.cpu() for x in decode(
                sc, llr[:batch].to(dev), algo=algo, iters=3,
                schedule="windowed", window=8, window_sweep=sweep)]
            want = build_windowed_decoder(sc, 8, 3, algo, sweep=sweep,
                                          device="cpu")(llr[:batch])
            err, share = _diff(got, want)
            what = (f"sc_l32_z64 W=8 3 it/window {sweep} {algo} 2.0 dB "
                    f"b={batch}: ok={float(got[1].double().mean()):.4f}")
            if algo == "sumproduct":
                if share < SP_MIN_AGREEMENT:
                    raise AssertionError(f"{what}: card and CPU agree on "
                                         f"{share:.6f} of frames")
                print(f"[4 windowed] {what}; card and CPU agree on "
                      f"{share:.6f} of frames")
            elif err:
                raise AssertionError(f"{what}: card != CPU")
            else:
                print(f"[4 windowed] {what}; card == CPU bit for bit")
    # the full-window pins: one slide of all 34 rows, 12 iterations, is
    # the flooding decoder (K1) or the layered one (K2) with ET off
    pin = llr.to(dev)
    for sweep, kname in (("flooding", "minsum_flood"),
                         ("layered", "minsum_layered")):
        got = build_windowed_decoder(sc, sc.mb, 12, sweep=sweep,
                                     device=dev)(pin)
        want = kernel(kname, sc, 12, False)(pin)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"full-window {sweep} != {kname} ET off")
        print(f"[4 windowed] sc_l32_z64 W=mb=34 12 it {sweep} == {kname} "
              f"ET off (bits, ok) b={SC_BATCH}, "
              f"ok={float(got[1].double().mean()):.4f}")
    for sweep, errors in WINDOWED_ROWS.items():
        cfg = DecodeCfg(schedule="windowed", window=8, iters=3,
                        window_sweep=sweep)
        _run_ber_check(run_ber, sc, cfg, f"windowed W=8 3 it {sweep}", 8,
                       frames=WINDOWED_FRAMES, batch=SC_BATCH,
                       ref=_wilson_interval(errors, WINDOWED_FRAMES),
                       ebn0=WINDOWED_EBN0)

    for argv, what in (
            (["--family", "sc", "--sc-length", "32", "--z", "64",
              "--schedule", "windowed", "--window", "8", "--window-sweep",
              "layered", "--iters", "4", "--ebn0", "3.0", "--max-frames",
              "4096"], "schedule=windowed window=8 sweep=layered"),
            (["--family", "judged", "--algo", "bitflip", "--ebn0", "4.0",
              "--max-frames", "4096"], "algo=bitflip")):
        csv = os.path.join(OUT_DIR, f"slice8_{argv[1]}.csv")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main([*argv, "--device", dev.type, "--csv", csv])
        with open(csv) as f:
            row = f.read().strip().splitlines()[-1].split(",")
        if int(row[1]) < 1 or what not in out.getvalue():
            raise AssertionError(f"CLI {argv}: CSV row {row}")
        print(f"[4 cli] {' '.join(argv)}: wrote {csv}: frames={row[1]} "
              f"FER={row[7]}")


def _slice8_times(dev):
    """ms per batch (CUDA events), info bits/s, device events per decode
    and their summed device time of the hard decoders (judged, b=4096, 50
    it) and the windowed decoder (sc_l32_z64, b=1024, W=8)."""
    import torch

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
    from tpu_ldpc_torch.decode.hard import build_hard_decoder
    from tpu_ldpc_torch.decode.windowed import build_windowed_decoder
    from tpu_ldpc_torch.encode.encoder import select_encoder

    t0 = time.perf_counter()
    judged = LdpcCode.judged()
    sc = LdpcCode.from_base_graph(make_sc_base_graph(32, 64), 64,
                                  "sc_l32_z64")
    k_sc = select_encoder(sc, device=dev)[1]  # the chain's true dimension
    awgn = torch.from_numpy(_noisy_llrs(judged, BATCH, 4.0, SEED + 50))
    bsc, _ = _bsc_llrs(judged, BATCH, 0.002, SEED + 51)
    cases = [(f"{algo} judged {label} b={BATCH} 50 it", judged.k,
              build_hard_decoder(judged, algo, 50, device=dev), llr.to(dev))
             for label, llr in (("AWGN 4.0 dB", awgn), ("BSC p=0.002", bsc))
             for algo in ("bitflip", "wbf")]
    for sweep, ipw, ebn0 in (("flooding", 3, 2.0), ("layered", 3, 2.0),
                             ("layered", 4, 3.0)):
        llr = _zero_codeword_llrs(sc, SC_BATCH, ebn0, SEED + 53).to(dev)
        cases.append((f"windowed sc_l32_z64 W=8 {ipw} it/window {sweep} "
                      f"min-sum {ebn0} dB b={SC_BATCH}", k_sc,
                      build_windowed_decoder(sc, 8, ipw, sweep=sweep,
                                             device=dev), llr))
    for what, k, fn, llr in cases:
        out = fn(llr)  # warm-up
        torch.cuda.synchronize()
        ms = [_cuda_time_ms(lambda: fn(llr), 5) for _ in range(2)]
        events, busy_ms = _device_events(lambda: fn(llr))
        batch_ms = sum(ms) / 2
        print(f"[5 slice8] {what}: {batch_ms:.4f} ms/batch ({ms[0]:.4f}, "
              f"{ms[1]:.4f}) = {llr.shape[0] * k / batch_ms * 1e3:.4e} info "
              f"bit/s; {events} device events a decode, busy "
              f"{busy_ms:.4f} ms ({100 * busy_ms / batch_ms:.1f}% of the "
              f"untraced time; profiler); "
              f"ok={float(out[1].double().mean()):.4f} "
              f"mean_iters={float(out[2].double().mean()):.3f}")
    print(f"[5 slice8] wall {time.perf_counter() - t0:.2f} s")


def _census_code():
    """(nr2_r15_z64, the census's harvest_failures keywords)."""
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    code = nrlike_code("1/5", 64, bg=2)
    return code, dict(CENSUS_KW, n_punct=2 * code.Z)


def _recording(fn, out):
    """fn, its last input and output kept in out['llr'] and out['out']."""
    def dec(llr):
        out["llr"], out["out"] = llr, fn(llr)
        return out["out"]
    return dec


def _slice9_kernels(dev, kernel, plain):
    """Phase 3 for slice 9: K1 on the census's first chunk and K3 on the
    judged code's impulse probes against their plain versions on the
    card, through the entry points' decoder hooks.  kernel / plain:
    main()'s builders.  Returns (K1 max |diff|, K3 max |diff|, K3 frame
    agreement, the K1 run's chunk-0 failures, the K3 probe run)."""
    import dataclasses

    import torch

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes.dmin import estimate_dmin_impulse
    from tpu_ldpc_torch.codes.trapping import harvest_failures

    code, kw = _census_code()
    runs, fails = {}, {}
    for label, build in (("kernel", kernel), ("plain", plain)):
        dec = _recording(build("minsum_flood", code, 50, True),
                         runs.setdefault(label, {}))
        fails[label], _ = harvest_failures(
            code, CENSUS_EBN0, target=10**9, max_frames=kw["chunk"],
            decode=lambda llr, dec=dec: dec(torch.from_numpy(llr).to(dev)),
            **kw)
    err_k1, _ = _diff(runs["kernel"]["out"], runs["plain"]["out"])
    same = ([dataclasses.astuple(f) for f in fails["kernel"]]
            == [dataclasses.astuple(f) for f in fails["plain"]])
    what = (f"minsum_flood {code.name} census chunk 0 ({CENSUS_EBN0} dB, "
            f"2Z erased, b={kw['chunk']}, 50 it ET on)")
    if err_k1 or not same:
        raise AssertionError(f"{what}: kernel != plain (max |diff| {err_k1},"
                             f" failures equal: {same})")
    print(f"[3 slice9] {what}: bit-exact; {len(fails['kernel'])} failures, "
          "equal to the plain version's field for field")

    judged = LdpcCode.judged()
    probes = {}
    for label, build in (("kernel", kernel), ("plain", plain)):
        rec = probes.setdefault(label, {})
        rec["ub"], rec["stats"] = estimate_dmin_impulse(
            judged, decoder=_recording(
                build("sumproduct_flood", judged, 60, True), rec),
            device=dev)
    err_k3, share = _diff(probes["kernel"]["out"], probes["plain"]["out"])
    st, pst = probes["kernel"]["stats"], probes["plain"]["stats"]
    what = (f"sumproduct_flood judged impulse probes b={st['probes']} 60 it "
            f"ET on: weight_min {st['weight_min']} (plain "
            f"{pst['weight_min']}), converged_nonzero "
            f"{st['converged_nonzero']} (plain {pst['converged_nonzero']})")
    if (share < SP_MIN_AGREEMENT
            or (st["weight_min"], st["converged_nonzero"])
            != (pst["weight_min"], pst["converged_nonzero"])):
        raise AssertionError(f"{what}: frames agree {share:.6f}")
    print(f"[3 slice9] {what}; kernel and plain agree on {share:.6f} of "
          "frames (bits, ok, iters_used)")
    return err_k1, err_k3, share, fails["kernel"], probes["kernel"]


def _slice9_path(dev, chunk0, probe):
    """The slice-9 main path through its entry points, each on its
    default decoder on the card: the census (K1), the impulse probe on the
    judged and the toy code (K3), the construction CLI in a subprocess
    (the native helper built with g++) and generate_family_cell."""
    import dataclasses

    from tpu_ldpc_torch import LdpcCode, _native
    from tpu_ldpc_torch.codes import base_graphs
    from tpu_ldpc_torch.codes.dmin import estimate_dmin_impulse
    from tpu_ldpc_torch.codes.trapping import census, harvest_failures

    code, kw = _census_code()
    with open(CENSUS_JSON) as f:
        frozen = next(p for p in json.load(f)["points"]
                      if p["ebn0_db"] == CENSUS_EBN0)
    t0 = time.perf_counter()
    fails, frames = harvest_failures(
        code, CENSUS_EBN0, target=CENSUS_TARGET, max_frames=CENSUS_MAX_FRAMES,
        target_info_wrong=True, device=dev, **kw)
    wall = time.perf_counter() - t0
    info = [f for f in fails if f.info_wrong > 0]
    rep = census(info)
    top = [(c["a"], c["b"], c["count"]) for c in rep["classes"][:5]]
    ftop = [(c["a"], c["b"], c["count"])
            for c in frozen["census_info_wrong"]["classes"][:5]]
    if ([dataclasses.astuple(f) for f in fails if f.chunk == 0]
            != [dataclasses.astuple(f) for f in chunk0]):
        raise AssertionError("census chunk 0 differs from phase 3's K1 run")
    exact = {
        "frames": frames == frozen["frames"],
        "failed_frames": len(fails) == frozen["n_failed_frames"],
        "info_wrong": len(info) == frozen["census_info_wrong"]["n_failures"],
        "top5": top == ftop}
    print(f"[4 census] {code.name} {CENSUS_EBN0} dB, 2Z erased, K1 50 it "
          f"ET on, chunk {kw['chunk']}: frames={frames} failed frames="
          f"{len(fails)} info-wrong={len(info)} undetected="
          f"{rep['undetected']['count']} top (a, b, count) {top}; frozen "
          f"row: frames={frozen['frames']} failed frames="
          f"{frozen['n_failed_frames']} info-wrong="
          f"{frozen['census_info_wrong']['n_failures']} top {ftop}; exactly "
          f"equal: {exact}; wall {wall:.2f} s "
          f"({frames // kw['chunk']} chunks)")
    for label, got, want in (
            ("fer_info", len(info), frozen["census_info_wrong"]["n_failures"]),
            ("detected_rate", len(fails), frozen["n_failed_frames"])):
        lo, hi = _wilson_interval(got, frames)
        rlo, rhi = _wilson_interval(want, frozen["frames"])
        print(f"[4 census] {label} {got / frames:.4e} CI95=[{lo:.4e}, "
              f"{hi:.4e}], frozen {want / frozen['frames']:.4e} "
              f"[{rlo:.4e}, {rhi:.4e}]")
        if not (lo <= rhi and rlo <= hi):
            raise AssertionError(f"census {label}: [{lo:.4e}, {hi:.4e}] "
                                 f"misses [{rlo:.4e}, {rhi:.4e}]")

    t0 = time.perf_counter()
    ub, st = estimate_dmin_impulse(LdpcCode.judged())
    wall = time.perf_counter() - t0
    if st != probe["stats"]:
        raise AssertionError(f"judged probe {st} != phase 3's "
                             f"{probe['stats']}")
    print(f"[4 dmin] judged impulse probe (K3, {st['probes']} frames): "
          f"ub={ub} converged_nonzero={st['converged_nonzero']}, wall "
          f"{wall:.2f} s")
    toy = LdpcCode.from_base_graph(
        base_graphs.make_base_graph(4, 6, 4, seed=5), 4)
    ub, st = estimate_dmin_impulse(toy)
    if ub != TOY_DMIN:
        raise AssertionError(f"toy impulse probe: ub {ub} != {TOY_DMIN}")
    print(f"[4 dmin] toy n={toy.n} impulse probe (K3, {st['probes']} "
          f"frames): ub={ub} (exact d_min {TOY_DMIN}), converged_nonzero="
          f"{st['converged_nonzero']}")

    t0 = time.perf_counter()
    so = _native.lib()
    print(f"[4 native] _native/native.cpp built with g++ and loaded in "
          f"{time.perf_counter() - t0:.2f} s: {so._name}")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tpu_ldpc_torch.cli.codegen", *CODEGEN_ARGV],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    for line in out.stdout.strip().splitlines():
        print(f"[4 codegen] {line}")
    if out.returncode != 0 or not all(
            key in out.stdout for key in ("pexit search: threshold",
                                          "annealed:", "PEXIT BP-threshold",
                                          "girth>=", "d_min <=")):
        raise AssertionError(f"codegen CLI rc={out.returncode}: "
                             f"{out.stderr[-2000:]}")
    print(f"[4 codegen] {' '.join(CODEGEN_ARGV)}: wall {wall:.2f} s")
    family, rate, Z = NEW_CELL
    if Z in base_graphs.FAMILY_LIFTS[family]:
        raise AssertionError(f"{NEW_CELL} is a committed cell")
    t0 = time.perf_counter()
    B = base_graphs.generate_family_cell(
        family, rate, Z, base_graphs.family_cell_seed(family, rate, Z))
    wall = time.perf_counter() - t0
    cell = LdpcCode.from_base_graph(B, Z, "new_cell")
    cell.parity_M  # raises unless the parity part is invertible
    print(f"[4 codegen] generate_family_cell{NEW_CELL}: n={cell.n} "
          f"k={cell.k} 4-cycles={base_graphs.count_4cycles(B, Z)} "
          f"6-cycles={base_graphs.count_6cycles(B, Z)} girth>="
          f"{cell.girth_lower_bound()}, encodable; wall {wall:.2f} s")


def _slice9_times(dev, probe, smi):
    """ms per census chunk: K1 (CUDA events) and the host's share (NumPy
    draws and encode, the copies to and from the card, classify; host
    clock); the probe's K3 ms; each beside the card's name and limit."""
    import torch

    import numpy as np

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes.gf2 import encode, parity_map
    from tpu_ldpc_torch.codes.trapping import chunk_frames, classify
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

    t_phase = time.perf_counter()
    code, kw = _census_code()
    chunk = kw["chunk"]
    dec = build_cuda_decoder(code, "minsum", kw["iters"], kw["alpha"],
                             early_stop=True, normalize=False)
    M = parity_map(code.H)
    host = {"draws+encode": [], "to card": [], "to host": [],
            "classify": []}
    for ci in range(4):  # chunk 0 warms up
        t0 = time.perf_counter()
        c, llr = chunk_frames(code, M, code.name, CENSUS_EBN0, ci, chunk,
                              kw["n_punct"])
        t1 = time.perf_counter()
        llr_dev = torch.from_numpy(llr).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = dec(llr_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        bits = out[0].cpu().numpy()
        t4 = time.perf_counter()
        classify(code.H, c, bits, code.k, chunk=ci)
        t5 = time.perf_counter()
        if ci:
            for key, dt in zip(host, (t1 - t0, t2 - t1, t4 - t3, t5 - t4)):
                host[key].append(1e3 * dt)
    k1_ms = [_cuda_time_ms(lambda: dec(llr_dev), 10) for _ in range(2)]
    k1 = sum(k1_ms) / 2
    iters_on = float(out[2].double().sum())
    bound, by = _bound_ms(code, chunk, "minsum", iters_on)
    print(f"[5 slice9] census chunk {code.name} b={chunk} {CENSUS_EBN0} dB "
          f"2Z erased, K1 50 it ET on (mean iters {iters_on / chunk:.3f}): "
          f"{k1:.4f} ms ({k1_ms[0]:.4f}, {k1_ms[1]:.4f}); bound "
          f"{bound:.5f} ms ({by}); {smi}")
    host_ms = sum(sum(v) / len(v) for v in host.values())
    print(f"[5 slice9] census chunk host: {host_ms:.4f} ms = "
          + ", ".join(f"{k} {sum(v) / len(v):.4f}" for k, v in host.items())
          + f" ms (host clock, mean of chunks 1-3); host / K1 "
          f"{host_ms / k1:.1f}x; {smi}")
    u = np.random.default_rng(SEED).integers(0, 2, (chunk, code.k)).astype(
        np.uint8)
    t0 = time.perf_counter()
    for _ in range(3):
        encode(code.H, u, M)
    enc_ms = (time.perf_counter() - t0) / 3 * 1e3
    draws_ms = sum(host["draws+encode"]) / 3
    print(f"[5 slice9] of draws+encode: encode (float32 BLAS product) "
          f"{enc_ms:.4f} ms, so the draws and LLRs {draws_ms - enc_ms:.4f} "
          f"ms (host clock); {smi}")

    judged = LdpcCode.judged()
    sp = build_cuda_decoder(judged, "sumproduct", 60, early_stop=True,
                            normalize=False)
    llr = probe["llr"]
    out = sp(llr)
    torch.cuda.synchronize()
    k3_ms = [_cuda_time_ms(lambda: sp(llr), 5) for _ in range(2)]
    k3 = sum(k3_ms) / 2
    iters_on = float(out[2].double().sum())
    bound, by = _bound_ms(judged, llr.shape[0], "sumproduct", iters_on)
    print(f"[5 slice9] impulse probe judged b={llr.shape[0]} K3 60 it ET on "
          f"(mean iters {iters_on / llr.shape[0]:.3f}): {k3:.4f} ms "
          f"({k3_ms[0]:.4f}, {k3_ms[1]:.4f}); bound {bound:.5f} ms ({by}); "
          f"{smi}")
    print(f"[5 slice9] wall {time.perf_counter() - t_phase:.2f} s")


# slice 10: distribution.  World 1 runs NCCL in this process (a group of
# one on an in-process store); two ranks share the one card over gloo
# (spawned processes that compute on cuda:0, collectives staged through
# the host: NCCL refuses two ranks on one card).  The MC counters must
# equal the single-device ones exactly: world 1 run_ber and the grid
# sweep against run_ber and the single-device batches, two ranks against
# the replay of both rank streams.  The ring decoder on sc_l128_z64 and
# the partitioned decoder on the 12x24 Z=512 code (flooding state 394 KB
# and 320 KB, beyond one block's 227 KB) decode random codewords at an
# Eb/N0 where the plain decoder converges on about half of the frames:
# the two ranks' output on the card equals the same two ranks' output on
# the CPU bit for bit (first DIST_CPU_FRAMES frames), it agrees with the
# plain single-device decoder on >= DIST_MIN_AGREEMENT of frames (the
# distributed posterior sums in another order), and every ok frame is
# syndrome-valid.
DIST_GRID = (1.5, 2.0, 2.5)
DIST_MAX_FRAMES = 65536
DIST_ITERS, DIST_BATCH, DIST_MIN_AGREEMENT = 20, 1024, 0.95
DIST_CPU_FRAMES = 64
DIST_CLI = ["--family", "judged", "--ebn0", "1.5", "2.0", "--device",
            "cuda", "--batch", str(BATCH)]


def _dist_codes():
    """{decoder: (code, Eb/N0 of its LLRs)}: the two codes build_decode_fn
    (mesh=...) routes away from the flooding kernel, each at an Eb/N0
    where min-sum at DIST_ITERS converges on about half of the frames."""
    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes import make_base_graph
    from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph

    return {
        "ring": (LdpcCode.from_base_graph(make_sc_base_graph(128, 64), 64,
                                          "sc_l128_z64"), 1.9),
        "partitioned": (LdpcCode.from_base_graph(
            make_base_graph(12, 24, 512, seed=3), 512, "nonbanded_z512"),
            2.25),
    }


def _dist_decoder(kind, code, mesh):
    from tpu_ldpc_torch.dist.partitioned import build_partitioned_decoder
    from tpu_ldpc_torch.dist.ring import build_ring_decoder

    build = build_ring_decoder if kind == "ring" else build_partitioned_decoder
    return build(code, mesh, algo="minsum", iters=DIST_ITERS, alpha=0.75,
                 beta=0.0)


def _fields(results):
    """SnrResults as dicts without their wall time."""
    import dataclasses

    return [{k: v for k, v in dataclasses.asdict(r).items() if k != "wall_s"}
            for r in results]


def _check_grid(points, what):
    """Each grid point's counters equal the sum of the single-device
    batches (build_mc_step, one batch a call) whose ctrs it issued."""
    import numpy as np

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.sim.mc import COUNTER_FIELDS, DecodeCfg, build_mc_step

    step = build_mc_step(LdpcCode.judged(), DecodeCfg(), BATCH, 1,
                         device="cuda")
    for p, (ebn0, r) in enumerate(zip(DIST_GRID, points)):
        got = [r[f] for f in COUNTER_FIELDS]
        want = sum(np.asarray(step(SEED, p, ebn0, ctr).tolist())
                   for ctr in range(r["frames"] // BATCH))
        if got != want.tolist():
            raise AssertionError(f"{what} grid point {ebn0} dB: {got} != "
                                 f"the single-device batches {want}")
        print(f"[4 dist] {what} grid {ebn0} dB: frames={r['frames']} "
              f"frame_errors={r['frame_errors']} == the single-device "
              f"batches 0..{r['frames'] // BATCH - 1}")


def _codeword_llrs(code, batch, ebn0_db, seed, dev):
    """((batch, n) float32 CPU LLRs, (batch, n) uint8 CPU codewords) of
    random codewords over AWGN, Eb/N0 referenced to the design rate.  The
    codewords are the pivot encoder's (``encode/encoder.py``: an SC
    chain's H is rank-deficient), its GF(2) row reduction on the native
    helper and its product on `dev`."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from tpu_ldpc_torch import _native

    H = np.asarray(sp.csr_matrix(code.H).todense())
    rref, pivots = _native.gf2_row_reduce(H)
    free = np.setdiff1d(np.arange(code.n), pivots)
    MT = torch.from_numpy(
        rref[:len(pivots)][:, free].T.astype(np.float64)).to(dev)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, len(free))).astype(np.uint8)
    c = np.zeros((batch, code.n), np.uint8)
    c[:, free] = u
    c[:, pivots] = torch.remainder(torch.from_numpy(u).to(dev).double() @ MT,
                                   2.0).to(torch.uint8).cpu().numpy()
    cw = torch.from_numpy(c)
    if not _syndrome_valid(code, cw, torch.ones(batch, dtype=torch.bool)):
        raise AssertionError(f"{code.name}: a drawn codeword violates H")
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return torch.from_numpy((2.0 / sigma2 * y).astype(np.float32)), cw


def _syndrome_valid(code, bits, ok):
    """True when every ok frame of bits satisfies H (on bits' device)."""
    from tpu_ldpc_torch.decode.reference import (
        _block_structure, _syndrome_ok)

    edges, row_edges, _ = _block_structure(code)
    P = -bits.float().view(bits.shape[0], code.nb, code.Z)  # bit 1: < 0
    return bool(_syndrome_ok(P, edges, row_edges)[ok].all())


def _slice10_rank(rank, port, out_dir):
    """One of the two gloo ranks on the one card (chip_smoke.py
    --slice10-rank R PORT DIR): the sharded MC step (its counters and
    host time a call), the grid sweep, the ring and partitioned decoders
    on DIR/slice10_llrs.pt; results to DIR/slice10_rank<R>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.decode.cuda_bp import LAUNCHES, reset_launches
    from tpu_ldpc_torch.dist import (
        build_sharded_mc_step, init_distributed, make_mesh)
    from tpu_ldpc_torch.dist.grid import run_ber_grid
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE="2", LOCAL_RANK=rank, LOCAL_WORLD_SIZE="2")
    init_distributed(backend="gloo", device="cuda",
                     timeout=datetime.timedelta(seconds=120))
    reset_launches()
    mesh = make_mesh(device="cuda:0")
    judged = LdpcCode.judged()
    step = build_sharded_mc_step(judged, DecodeCfg(), BATCH, mesh,
                                 steps_per_call=8)
    out = {"step": step(SEED, 0, 2.0, 0).tolist(), "step_ms": []}
    for c in range(1, 6):
        t0 = time.perf_counter()
        step(SEED, 0, 2.0, 8 * c).tolist()  # waits for the counters
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["grid"] = _fields(run_ber_grid(
        judged, DIST_GRID, DecodeCfg(), BATCH, 100, DIST_MAX_FRAMES, SEED,
        mesh))
    llrs = torch.load(os.path.join(out_dir, "slice10_llrs.pt"))
    for kind, (code, _) in _dist_codes().items():
        fn = _dist_decoder(kind, code, mesh)
        llr = llrs[kind][0].to(mesh.device)
        fn(llr)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(llr)
        torch.cuda.synchronize()
        out[f"{kind}_ms"] = (time.perf_counter() - t0) * 1e3
        out[kind] = [x.cpu() for x in res]
        # the same two ranks on the CPU (gloo needs no staging there)
        out[f"{kind}_cpu"] = fn(llrs[kind][0][:DIST_CPU_FRAMES])
    out["launches"] = {k: n for k, n in LAUNCHES.items() if n}
    dist.barrier()
    dist.destroy_process_group()
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "tpu_ldpc"))
    torch.save(out, os.path.join(out_dir, f"slice10_rank{rank}.pt"))
    return 0


def _spawn(argv, **kw):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    # a session of its own: _wait kills torchrun's workers with it
    return subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, **kw)


def _wait(procs, timeout):
    """{name: (rc, output)} of every process; on a timeout or a failure
    here, kills every process group still running."""
    import signal

    outs = {}
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=timeout)
            outs[name] = (p.returncode, out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


def _csv_rows(path):
    """A sweep CSV's rows without the wall time (the last column)."""
    with open(path) as f:
        lines = f.read().strip().splitlines()
    return [ln.rsplit(",", 1)[0] for ln in lines[1:]]


def _slice10_path(dev):
    """Distribution: world-1 NCCL run_ber(mesh) and the grid sweep against
    the single-device counters, two gloo ranks on the one card against
    the replay of their streams, the ring and partitioned decoders
    against the same ranks on the CPU and the plain decoder,
    build_decode_fn's routing, the launcher.  Returns the two ranks'
    results; their K1 launches are checked here and kept out of LAUNCHES,
    which counts this process's launches."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_ldpc_torch import LdpcCode, _build
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.decode.flood_plan import (
        SMEM_LIMIT_BYTES, code_flood_smem_bytes, flood_plan, flood_smem_bytes)
    from tpu_ldpc_torch.decode.reference import build_decoder
    from tpu_ldpc_torch.dist import init_distributed, make_mesh
    from tpu_ldpc_torch.dist.grid import run_ber_grid
    from tpu_ldpc_torch.sim.mc import BatchFn, DecodeCfg, run_ber
    from tpu_ldpc_torch.dist.mesh import fold_generator_rank

    judged = LdpcCode.judged()
    cfg = DecodeCfg()
    os.makedirs(OUT_DIR, exist_ok=True)
    # the launcher's runs and the refusal start now, in parallel; each
    # process builds nothing (phase 2's libraries are in build/)
    trace_dir = os.path.join(OUT_DIR, "slice10_profile")
    csvs = {k: os.path.join(OUT_DIR, f"slice10_{k}.csv")
            for k in ("launch", "single")}
    torchrun = ["-m", "torch.distributed.run", "--standalone"]
    cli = {
        "launch": _spawn(torchrun + [
            "--nproc-per-node", "1", "-m", "tpu_ldpc_torch.cli.launch", "--",
            *DIST_CLI, "--csv", csvs["launch"], "--profile", trace_dir]),
        "single": _spawn(["-m", "tpu_ldpc_torch.sim", *DIST_CLI, "--csv",
                          csvs["single"]]),
        "two ranks": _spawn(torchrun + [
            "--nproc-per-node", "2", "-m", "tpu_ldpc_torch.cli.launch", "--",
            *DIST_CLI]),
    }

    # world 1, NCCL, in this process
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        os.environ.pop(var, None)
    init_distributed(device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"world 1 on the card: {dist.get_backend()}")
    mesh = make_mesh()
    kw = dict(batch=BATCH, target_frame_errors=100,
              max_frames=DIST_MAX_FRAMES, seed=SEED, steps_per_call=8,
              device="cuda")
    got = _fields(run_ber(judged, [2.0], cfg, mesh=mesh, **kw))
    want = _fields(run_ber(judged, [2.0], cfg, **kw))
    if got != want:
        raise AssertionError(f"world-1 run_ber(mesh) {got} != run_ber {want}")
    print(f"[4 dist] world 1 NCCL run_ber(mesh) judged 2.0 dB b={BATCH} "
          f"spc 8 == run_ber field for field: {got[0]}")
    _check_grid(_fields(run_ber_grid(judged, DIST_GRID, cfg, BATCH, 100,
                                     DIST_MAX_FRAMES, SEED, mesh)),
                "world 1 NCCL")

    # routing at world 1, and the host smem function against the library
    codes = _dist_codes()
    llrs = {kind: _codeword_llrs(code, DIST_BATCH, ebn0, SEED + 60 + i, dev)
            for i, (kind, (code, ebn0)) in enumerate(codes.items())}
    torch.save(llrs, os.path.join(OUT_DIR, "slice10_llrs.pt"))
    dcfg = DecodeCfg(iters=DIST_ITERS)
    for kind, (code, _) in codes.items():
        fn = build_decode_fn(code, dcfg, "cuda", mesh=mesh)
        if fn is not _dist_decoder(kind, code, mesh):
            raise AssertionError(f"{code.name}: not routed to {kind}")
        llr = llrs[kind][0]
        card = fn(llr.to(dev))
        cpu = fn(llr[:DIST_CPU_FRAMES])
        if any(not torch.equal(a[:DIST_CPU_FRAMES].cpu(), b)
               for a, b in zip(card, cpu)):
            raise AssertionError(f"{kind} on the card != on the CPU")
        print(f"[4 dist] routing: {code.name} (flooding state "
              f"{code_flood_smem_bytes(code)} B > {SMEM_LIMIT_BYTES}) -> "
              f"{kind} decoder; card == CPU on {DIST_CPU_FRAMES} frames, "
              f"bit for bit (ok {float(cpu[1].double().mean()):.4f})")
    lib = _build.load_library("bp_flood")
    for code in (judged, LdpcCode.from_family("wifi", "2/3", 27),
                 LdpcCode.from_family("wimax", "5/6", 96),
                 LdpcCode.from_family("wimax", "1/2", 96),
                 codes["ring"][0]):
        lay = code.layout
        bucket = flood_plan(code, tuple(int(s) for s in lay.edge_shift)).bucket
        for bf16 in (0, 1):
            want = lib.ldpc_bp_flood_smem_bytes(code.Z, code.mb, code.nb,
                                                lay.E, bucket, bf16)
            if flood_smem_bytes(code.Z, code.mb, code.nb, lay.E, bucket,
                                bool(bf16)) != want:
                raise AssertionError(f"{code.name}: flood_smem_bytes")
        print(f"[4 dist] flood_smem_bytes == ldpc_bp_flood_smem_bytes: "
              f"{code.name} bucket {bucket}: {code_flood_smem_bytes(code)} B")

    # the launcher against the single-process sweep (done before the
    # gloo ranks start, so that their times see an idle card)
    outs = _wait(cli, 300)
    for name, (rc, out) in outs.items():
        print(f"[4 launch] {name}: rc={rc}, last lines: "
              f"{out.strip().splitlines()[-3:]}")
    if outs["launch"][0] or outs["single"][0]:
        raise AssertionError(f"launcher / sweep failed:\n{outs}")
    if _csv_rows(csvs["launch"]) != _csv_rows(csvs["single"]):
        raise AssertionError("torchrun CSV != single-process CSV")
    print(f"[4 launch] torchrun --nproc-per-node 1 CSV == python -m "
          f"tpu_ldpc_torch.sim CSV row for row: {_csv_rows(csvs['single'])}")
    if outs["two ranks"][0] == 0 or (
            "more ranks than cards" not in outs["two ranks"][1]):
        raise AssertionError("--nproc-per-node 2 on one card did not raise "
                             "'more ranks than cards'")
    print("[4 launch] --nproc-per-node 2 on one card: 'more ranks than "
          "cards', rc != 0")
    with open(os.path.join(trace_dir, "trace_rank0.json")) as f:
        trace = f.read()
    if "bp_flood_kernel" not in trace:
        raise AssertionError("the --profile trace holds no K1 launch")
    print(f"[4 launch] --profile: {len(trace)} B trace, "
          f"{trace.count('bp_flood_kernel')} mentions of bp_flood_kernel")
    # two ranks on the one card over gloo
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    ranks = {r: _spawn([os.path.abspath(__file__), "--slice10-rank", str(r),
                        port, OUT_DIR]) for r in range(2)}
    for r, (rc, out) in _wait(ranks, 600).items():
        if rc != 0:
            raise AssertionError(f"gloo rank {r} failed rc={rc}:\n{out}")
    res = [torch.load(os.path.join(OUT_DIR, f"slice10_rank{r}.pt"))
           for r in range(2)]
    if any(r["jax"] for r in res):
        raise AssertionError(f"a rank imported {res[0]['jax']}")
    if res[0]["step"] != res[1]["step"] or res[0]["grid"] != res[1]["grid"]:
        raise AssertionError("the two ranks' counters differ")
    one = BatchFn(judged, cfg, BATCH, "cuda")
    replay = sum(np.asarray(one(fold_generator_rank(SEED, 0, ctr, r, "cuda"),
                                2.0).tolist())
                 for ctr in range(8) for r in range(2))
    if res[0]["step"] != replay.tolist():
        raise AssertionError(f"two-rank step {res[0]['step']} != the "
                             f"replay of both rank streams {replay}")
    print(f"[4 dist] two gloo ranks on one card: sharded step (b={BATCH} a "
          f"rank, spc 8, 2.0 dB) {res[0]['step']} == the replay of both "
          "rank streams through K1")
    _check_grid(res[0]["grid"], "two gloo ranks")
    for kind, (code, ebn0) in codes.items():
        for key in (kind, f"{kind}_cpu"):
            for a, b in zip(res[0][key], res[1][key]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{key}: the ranks' outputs differ")
        if any(not torch.equal(a[:DIST_CPU_FRAMES], b)
               for a, b in zip(res[0][kind], res[0][f"{kind}_cpu"])):
            raise AssertionError(f"{kind}: two ranks on the card != the "
                                 "same two ranks on the CPU")
        llr, cw = llrs[kind]
        bits, ok, iu = (x.to(dev) for x in res[0][kind])
        pb, pok, piu = build_decoder(code, "minsum", DIST_ITERS)(llr.to(dev))
        share = float(((bits == pb).all(dim=1) & (ok == pok)).double().mean())
        valid = _syndrome_valid(code, bits, ok)
        cw = cw.to(dev)
        right, pright = (float((b == cw).all(dim=1).double().mean())
                         for b in (bits, pb))
        plain_ok = float(pok.double().mean())
        print(f"[4 dist] {kind} {code.name} two ranks b={DIST_BATCH} "
              f"{ebn0} dB min-sum {DIST_ITERS} it, random codewords: card "
              f"== CPU on {DIST_CPU_FRAMES} frames bit for bit; agreement "
              f"with the plain decoder {share:.6f}, ok "
              f"{float(ok.double().mean()):.4f} (plain {plain_ok:.4f}), "
              f"codeword recovered {right:.4f} (plain {pright:.4f}), ok "
              f"frames syndrome-valid {valid}")
        if share < DIST_MIN_AGREEMENT or not valid:
            raise AssertionError(f"{kind}: agreement {share}, valid {valid}")
        if not 0.1 <= plain_ok <= 0.9:
            raise AssertionError(f"{kind}: the plain decoder converges on "
                                 f"{plain_ok} of frames: the check needs "
                                 "both outcomes")
    k1 = [r["launches"].get("minsum_flood", 0) for r in res]
    if min(k1) < 1:
        raise AssertionError(f"a gloo rank launched no K1: "
                             f"{[r['launches'] for r in res]}")
    print(f"[4 dist] K1 launches in the two gloo ranks: {k1[0]} / {k1[1]} "
          "(their own processes' counts, not in this path's count)")

    return res


def _slice10_times(dev, res, smi):
    """Host ms a call of the world-1 sharded step (NCCL all_reduce) against
    run_ber's step, the two gloo ranks' step (host staging included), the
    ring and partitioned decoders' ms a batch at world 1 (CUDA events)
    with device events and busy share (profiler), and their two-rank host
    ms; then the world-1 group is destroyed."""
    import torch
    import torch.distributed as dist

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.dist import build_sharded_mc_step, make_mesh
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    t0 = time.perf_counter()
    judged = LdpcCode.judged()
    mesh = make_mesh()
    steps = {"run_ber step": build_mc_step(judged, DecodeCfg(), BATCH, 8,
                                           device="cuda"),
             "world-1 sharded step": build_sharded_mc_step(
                 judged, DecodeCfg(), BATCH, mesh, steps_per_call=8)}
    ms = {name: [] for name in steps}
    for name in steps:
        steps[name](SEED, 0, 2.0, 0).tolist()
    for k, name in enumerate(list(steps) + list(steps)[::-1]):
        for c in range(5):
            t1 = time.perf_counter()
            steps[name](SEED, 0, 2.0, 8 * (c + 1 + 5 * k)).tolist()
            ms[name].append((time.perf_counter() - t1) * 1e3)
    for name, v in ms.items():
        m = sum(v) / len(v)
        print(f"[5 slice10] {name} judged b={BATCH} spc 8 2.0 dB: "
              f"{m:.4f} ms a call (host clock, mean of {len(v)}) = "
              f"{m / 8:.4f} ms a batch; {smi}")
    two = [sum(r["step_ms"]) / len(r["step_ms"]) for r in res]
    print(f"[5 slice10] two gloo ranks on one card, sharded step b={BATCH} a "
          f"rank spc 8: {two[0]:.4f} / {two[1]:.4f} ms a call (ranks 0 / 1, "
          f"host clock, {res[0]['step_ms']}) = "
          f"{2 * 8 * BATCH / (max(two) * 1e-3):.4e} frames/s together")
    llrs = torch.load(os.path.join(OUT_DIR, "slice10_llrs.pt"))
    for kind, (code, ebn0) in _dist_codes().items():
        fn = _dist_decoder(kind, code, mesh)
        llr = llrs[kind][0].to(dev)
        out = fn(llr)
        torch.cuda.synchronize()
        t_ms = [_cuda_time_ms(lambda: fn(llr), 3) for _ in range(2)]
        events, busy = _device_events(lambda: fn(llr))
        batch_ms = sum(t_ms) / 2
        print(f"[5 slice10] {kind} {code.name} world 1 NCCL b={DIST_BATCH} "
              f"{ebn0} dB min-sum {DIST_ITERS} it: {batch_ms:.4f} ms/batch "
              f"({t_ms[0]:.4f}, {t_ms[1]:.4f}), mean iters "
              f"{float(out[2].double().mean()):.3f}; {events} device events "
              f"a decode, busy {busy:.4f} ms ({100 * busy / batch_ms:.1f}% "
              f"of the untraced time; profiler); two gloo ranks "
              f"{res[0][f'{kind}_ms']:.4f} / {res[1][f'{kind}_ms']:.4f} ms "
              f"(host clock)")
    dist.destroy_process_group()
    print(f"[5 slice10] wall {time.perf_counter() - t0:.2f} s")


def _strict_json(line):
    def refuse(constant):
        raise ValueError(f"non-strict JSON constant {constant}")

    return json.loads(line, parse_constant=refuse)


def _slice11_path(dev, smi):
    """The throughput CLI in this process: SLICE11_BENCH's records, each
    one JSON line equal to the record main returns, its info bits/s batch
    * k over its time, its decodes on its own kernels alone; (e)'s trace
    holds device events of bp_flood_kernel.  Then the registry validation
    (scripts/torch_registry_validation.py) capped at one chunk a cell:
    K1 bit for bit with the plain decoder on all 61 cells.  Returns the
    records by label."""
    import contextlib
    import importlib.util
    import io

    import torch

    from tpu_ldpc_torch.cli import bench
    from tpu_ldpc_torch.decode.cuda_bp import LAUNCHES

    t0 = time.perf_counter()
    trace_dir = os.path.join(OUT_DIR, "slice11_profile")
    records = {}
    print(f"[slice11] nvidia-smi: {smi}")
    for label, flags, own in SLICE11_BENCH:
        argv = ["--device", "cuda", "--batch", str(BATCH), *flags, "--json"]
        if label == "e":
            argv += ["--profile", trace_dir]
        before = dict(LAUNCHES)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rec = bench.main(argv)
        lines = out.getvalue().splitlines()
        if len(lines) != 1 or _strict_json(lines[0]) != rec:
            raise AssertionError(f"({label}): stdout is not one JSON line "
                                 f"equal to the record: {lines}")
        ms = rec["ms_per_batch"]
        if not (set(rec) == BENCH_KEYS and math.isfinite(ms) and ms > 0
                and math.isclose(rec["info_bits_per_s"],
                                 rec["batch"] * rec["k"] / (ms / 1e3),
                                 rel_tol=1e-12)
                and rec["device_kind"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"({label}): record {rec}")
        ran = {kname for kname, n in LAUNCHES.items()
               if n > before[kname] and not kname.endswith("_normalized")}
        if ran != own:
            raise AssertionError(f"({label}) launched {ran}, not {own}")
        records[label] = rec
        print(f"[slice11] ({label}) {lines[0]}")
    with open(os.path.join(trace_dir, "trace_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "bp_flood_kernel" in e.get("name", "")]
    if not k1:
        raise AssertionError("(e): no device event of bp_flood_kernel in "
                             "the trace")
    print(f"[slice11] (e) trace: {len(k1)} device events of "
          f"bp_flood_kernel, mean {sum(e['dur'] for e in k1) / len(k1):.2f}"
          " us (profiler)")

    spec = importlib.util.spec_from_file_location("torch_registry_validation",
                                                  REGISTRY_SCRIPT)
    reg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reg)
    reg_dir = os.path.join(OUT_DIR, "slice11_registry")
    os.makedirs(reg_dir, exist_ok=True)
    for work, name, punctured in (
            (list(reg.cells()), reg.OUT_NAMES[0], False),
            (list(reg.nr_operating_cells()), reg.OUT_NAMES[1], True)):
        t1 = time.perf_counter()
        rows, n_fail, *_ = reg.run_pass(work, os.path.join(reg_dir, name),
                                        punctured, dev, max_chunks=1,
                                        log=lambda line: None)
        if n_fail or len(rows) != len(work) or not all(
                r["bitexact"] is True and r["frames"] == reg.CHUNK
                for r in rows.values()):
            raise AssertionError(f"registry capped, {name}: "
                                 f"{[r for r in rows.values()]}")
        errors = sum(round(r["fer"] * r["frames"]) for r in rows.values())
        print(f"[slice11] registry capped at one chunk a cell, {name}: K1 "
              f"== plain (bits, ok, iters_used) on all {len(rows)} cells, "
              f"{len(rows) * reg.CHUNK} frames, {errors} frame errors, "
              f"wall {time.perf_counter() - t1:.2f} s")
    print(f"[slice11] wall {time.perf_counter() - t0:.2f} s")
    return records


def _load_script(name):
    """scripts/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the MC batch kernels (csrc/mc_batch.cu) against BatchFn's PyTorch ops on
# the card, bit for bit: a batch that is no multiple of kernel A's 16
# frames a block, three seeds (two above 2**31) and two Eb/N0 a case; then
# at the cells' shapes (judged b=16384, nrlike punctured b=4096 at Z = 64
# and Z = 384) checked again and timed
MC_BATCH = 4099
MC_SEEDS = (SEED + 70, 2**31 + 7, 2**33 + 5)
MC_EBN0 = (1.0, 2.0)
MC_TIME_SHAPES = (("judged", 16384, 2.0), ("nrlike punctured", 4096, 1.6),
                  ("nrlike z384 punctured", 4096, 1.2))


def _mc_batch_cases():
    """(label, code, adapt, crc) of each case of _mc_batch_path."""
    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.channel.adapt import RateAdapt
    from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
    from tpu_ldpc_torch.codes.crc import CrcSpec
    from tpu_ldpc_torch.codes.nrlike import nrlike_adapt, nrlike_code

    judged = LdpcCode.judged()
    nr, nr384 = nrlike_code("1/2", 64), nrlike_code("1/2", 384)
    sc = LdpcCode.from_base_graph(make_sc_base_graph(16, 64), 64,
                                  "sc_l16_z64")
    return (
        ("judged", judged, None, None),
        ("nrlike punctured", nr, nrlike_adapt(nr), None),
        ("nrlike z384 punctured", nr384, nrlike_adapt(nr384), None),
        ("judged shortened", judged, RateAdapt.from_blocks(
            judged, puncture_blocks=(15,), shorten_blocks=(0, 3)), None),
        ("judged crc24", judged, None, "crc24"),
        ("judged crc5", judged, None, CrcSpec("crc5", 5, 0x05)),
        ("sc pivot", sc, None, None),
    )


def _mc_batch_path(dev, smi):
    """mc_encode_llr and mc_count against BatchFn's plain versions
    (plain_llrs, plain_counters) on the card, LLRs as int32 and the
    counters exactly, over _mc_batch_cases; the regroup identity, the
    world-1 NCCL sharded step against the single-device step and both
    against the plain counters; launches on the main path; at the cells'
    shapes both kernels against the plain versions again, then each
    kernel's ms a batch beside its bound and its plain version's.  Returns
    the two kernels' rows of the kernel table, max_abs_err the largest
    |kernel - plain| of all those comparisons."""
    import torch
    import torch.distributed as dist

    from tpu_ldpc_torch.decode.cuda_bp import LAUNCHES as DEC_LAUNCHES
    from tpu_ldpc_torch.dist import init_distributed, make_mesh
    from tpu_ldpc_torch.dist.mesh import build_sharded_mc_step
    from tpu_ldpc_torch.sim import mc_batch
    from tpu_ldpc_torch.sim.mc import (
        BatchFn, DecodeCfg, batch_generator, build_mc_step)

    cfg = DecodeCfg()
    cases = _mc_batch_cases()
    max_err = {"mc_encode_llr": 0.0, "mc_count": 0}

    def compare(what, llr, want_llr, counts, want_counts):
        # LLRs as int32 and the counters exactly; raises on any difference
        llr_off = int((llr.view(torch.int32)
                       != want_llr.view(torch.int32)).sum())
        errs = {"mc_encode_llr": float((llr - want_llr).abs().max()),
                "mc_count": max(int((c - w).abs().max())
                                for c, w in zip(counts, want_counts))}
        for name, err in errs.items():
            max_err[name] = max(max_err[name], err)
        if llr_off or any(errs.values()):
            raise AssertionError(
                f"[mc_batch] {what}: {llr_off} LLRs differ (max |err| "
                f"{errs['mc_encode_llr']}); counters "
                f"{[c.tolist() for c in counts]} plain "
                f"{[w.tolist() for w in want_counts]}")

    for label, code, adapt, crc in cases:
        fn = BatchFn(code, cfg, MC_BATCH, dev, adapt, crc)
        if fn.kernels is None:
            raise AssertionError(f"{label}: BatchFn on the card took no "
                                 f"kernels")
        totals = torch.zeros(6, dtype=torch.int64)
        for seed in MC_SEEDS:
            for ebn0 in MC_EBN0:
                u, noise = fn.draw(batch_generator(seed, 0, 0, dev))
                um, want_llr = fn.plain_llrs(u, noise, ebn0)
                llr = fn.kernels.encode_llr(u, noise, ebn0, fn.rate)
                bits, ok, iu = fn.decode_fn(llr)
                want = fn.plain_counters(um, bits, ok, iu)
                got = fn.batch_counters(u, noise, ebn0)
                base = torch.arange(1, 7, dtype=torch.int64, device=dev)
                added = fn.batch_counters(u, noise, ebn0, out=base.clone())
                compare(f"{label} seed {seed} {ebn0} dB", llr, want_llr,
                        (got, added), (want, base + want))
                totals += want.cpu()
        print(f"[mc_batch] {label} {code.name} b={MC_BATCH} "
              f"(kp {fn.kp}, info_cols {fn.info_cols is not None}, masks "
              f"{fn.tx_mask is not None}): kernels == plain bit for bit on "
              f"{len(MC_SEEDS)} seeds x {MC_EBN0} dB; counters summed "
              f"{totals.tolist()}")

    # the main path: regroup, world-1 sharded step, launches
    judged = cases[0][1]
    seed, ebn0, b = MC_SEEDS[1], 2.0, 4096
    plain = BatchFn(judged, cfg, b, dev)
    want = torch.zeros(6, dtype=torch.int64, device=dev)
    for t in range(4):
        u, noise = plain.draw(batch_generator(seed, 0, t, dev))
        um, llr = plain.plain_llrs(u, noise, ebn0)
        want += plain.plain_counters(um, *plain.decode_fn(llr))
    mc_batch.reset_launches()
    dec0 = DEC_LAUNCHES["minsum_flood"]
    got = {spc: sum(build_mc_step(judged, cfg, b, spc, device=dev)(
        seed, 0, ebn0, c) for c in range(0, 4, spc)) for spc in (1, 2, 4)}
    launches = dict(mc_batch.LAUNCHES)
    dec = DEC_LAUNCHES["minsum_flood"] - dec0
    if launches != {"mc_encode_llr": 12, "mc_count": 12} or dec != 12:
        raise AssertionError(f"[mc_batch] 12 batches: {launches}, K1 {dec}")
    created = not dist.is_initialized()
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        os.environ.pop(var, None)
    init_distributed(device="cuda")
    try:
        got["sharded"] = build_sharded_mc_step(
            judged, cfg, b, make_mesh(), 4)(seed, 0, ebn0, 0)
    finally:
        if created:
            dist.destroy_process_group()
    for key, acc in got.items():
        if not torch.equal(acc, want):
            raise AssertionError(f"[mc_batch] step {key}: {acc.tolist()} "
                                 f"!= plain {want.tolist()}")
    print(f"[mc_batch] regroup spc 1 / 2 / 4 and the world-1 NCCL sharded "
          f"step == plain counters {want.tolist()} (judged b={b}, 4 "
          f"batches); launches {launches}, K1 {dec}")

    # times at the cells' shapes
    rows = {"mc_encode_llr": [], "mc_count": []}
    for label, b, ebn0 in MC_TIME_SHAPES:
        code, adapt, crc = next(c[1:] for c in cases if c[0] == label)
        fn = BatchFn(code, cfg, b, dev, adapt, crc)
        u, noise = fn.draw(batch_generator(MC_SEEDS[0], 0, 0, dev))
        um, want_llr = fn.plain_llrs(u, noise, ebn0)
        llr = fn.kernels.encode_llr(u, noise, ebn0, fn.rate)
        bits, ok, iu = fn.decode_fn(llr)
        out = torch.zeros(6, dtype=torch.int64, device=dev)
        compare(f"{label} b={b} {ebn0} dB", llr, want_llr,
                (fn.kernels.count(bits, u, ok, iu, out),),
                (fn.plain_counters(um, bits, ok, iu),))
        runs = {
            "mc_encode_llr": (
                lambda: fn.kernels.encode_llr(u, noise, ebn0, fn.rate),
                lambda: fn.plain_llrs(u, noise, ebn0),
                b * (fn.k_info + 8 * fn.n)),
            "mc_count": (
                lambda: fn.kernels.count(bits, u, ok, iu, out),
                lambda: fn.plain_counters(um, bits, ok, iu),
                b * (2 * fn.k_info + 5)),
        }
        for name, (kern, plain_fn, nbytes) in runs.items():
            kern(), plain_fn()
            torch.cuda.synchronize()
            p1 = _cuda_time_ms(plain_fn, 20)
            k1, k2 = _cuda_time_ms(kern, 100), _cuda_time_ms(kern, 100)
            p2 = _cuda_time_ms(plain_fn, 20)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound = nbytes / 3.35e12 * 1e3
            print(f"[mc_batch time] {name} {label} {code.name} b={b}: "
                  f"kernel {k_ms:.5f} ms/batch ({k1:.5f}, {k2:.5f}), "
                  f"bound {bound:.5f} ms ({nbytes} B at 3.35 TB/s, "
                  f"{bound / k_ms:.1%} of it), plain {p_ms:.5f} ms "
                  f"({p1:.5f}, {p2:.5f}); {smi}")
            rows[name].append((label, b, k_ms, bound, p_ms))
    return [{"name": name, "route": "cuda", "source": "csrc/mc_batch.cu",
             "replaces": "sim/mc.py::BatchFn torch ops (no TPU kernel)",
             "launches": launches[name],
             "max_abs_err": max_err[name],
             "ms": r[0][2], "plain_ms": r[0][4], "bound_ms": r[0][3],
             "bound_by": "bytes", "library_ms": None,
             "shapes": [list(x) for x in r]}
            for name, r in rows.items()]


# K1g (bp_flood_gmem_kernel): the MC cell nr1-z384-mc-1.2dB's shape, NR
# BG1 at Z = 384, whose flooding state outgrows one block's shared memory
GMEM_SHAPE = ("nrlike z384 punctured", 4096, 1.2)


def _gmem_path(dev, smi):
    """K1g on the card at GMEM_SHAPE, the launch counters reset first: one
    batch of the MC step's draws, kernel A's LLRs against plain_llrs,
    decoded by the step's build_decode_fn decoder (K1g) and by the plain
    decoder (impl='torch'), bits, ok and iters_used equal; kernel B's
    counters, and the counters of build_mc_step's own call on that batch,
    against plain_counters of the plain decode; decode() on the LLRs;
    every decode launches minsum_flood_gmem with L and P in shared memory
    (minsum_flood_gmem_smem), its rows in the one-gather form
    (minsum_flood_one_gather), and no shared-memory kernel.  Then K1g's ms a
    batch at 50 iterations ET off (and ET on at the cell's Eb/N0) beside
    its bound and the plain decoder's, in its own placement and with L and
    P in the scratch (the limit at 0), which must give the same bits.
    Returns K1g's row of the kernel table."""
    import torch

    from tpu_ldpc_torch.decode import cuda_bp, decode
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.decode.cuda_bp import (
        LAUNCHES, build_cuda_decoder, reset_launches)
    from tpu_ldpc_torch.decode.reference import build_decoder
    from tpu_ldpc_torch.sim.mc import (
        BatchFn, DecodeCfg, batch_generator, build_mc_step)

    label, b, ebn0 = GMEM_SHAPE
    code, adapt, crc = next(c[1:] for c in _mc_batch_cases()
                            if c[0] == label)
    cfg = DecodeCfg()
    seed = MC_SEEDS[1]
    reset_launches()
    fn = BatchFn(code, cfg, b, dev, adapt, crc)
    u, noise = fn.draw(batch_generator(seed, 0, 0, dev))
    um, want_llr = fn.plain_llrs(u, noise, ebn0)
    llr = fn.kernels.encode_llr(u, noise, ebn0, fn.rate)
    llr_off = int((llr.view(torch.int32) != want_llr.view(torch.int32)).sum())
    got = fn.decode_fn(llr)
    t0 = time.perf_counter()
    want = build_decode_fn(code, DecodeCfg(impl="torch"), dev)(want_llr)
    torch.cuda.synchronize()
    plain_on_s = time.perf_counter() - t0
    err, agree = _diff(got, want)
    want_counts = fn.plain_counters(um, *want)
    counts = fn.kernels.count(got[0], u, got[1], got[2], torch.zeros(
        6, dtype=torch.int64, device=dev))
    step_counts = build_mc_step(code, cfg, b, 1, adapt, crc,
                                device=dev)(seed, 0, ebn0, 0)
    dec = decode(code, llr)
    dec_err, _ = _diff(dec, got)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    iters_on = float(got[2].double().sum())
    print(f"[gmem] {label} {code.name} b={b} {ebn0} dB seed {seed}: "
          f"{llr_off} LLRs differ; K1g against the plain decoder (impl="
          f"'torch', {plain_on_s:.2f} s) max |err| {err}, frames agreeing "
          f"{agree}; decode() max |err| {dec_err}; counters kernel B "
          f"{counts.tolist()}, MC step {step_counts.tolist()}, plain "
          f"{want_counts.tolist()}; frames ok {int(got[1].sum())}, mean "
          f"iters {iters_on / b:.4f}; launches {launches}")
    if (llr_off or err or dec_err
            or not torch.equal(counts, want_counts)
            or not torch.equal(step_counts, want_counts)):
        raise AssertionError(f"[gmem] K1g's path differs from the plain "
                             f"versions at {GMEM_SHAPE}")
    if launches != {"minsum_flood": 3, "minsum_flood_gmem": 3,
                    "minsum_flood_gmem_smem": 3,
                    "minsum_flood_one_gather": 3}:
        raise AssertionError(f"[gmem] 3 decodes: launches {launches}")

    run_off = build_cuda_decoder(code, "minsum", 50, 0.75, 0.0, "flooding",
                                 False, normalize=False)
    run_on = build_cuda_decoder(code, "minsum", 50, 0.75, 0.0, "flooding",
                                True, normalize=False)
    plain_off = build_decoder(code, "minsum", 50, 0.75, 0.0, "flooding",
                              False)
    limit = cuda_bp.SMEM_LIMIT_BYTES

    def scratch_lp(run):
        """`run` with L and P in the scratch: the limit at 0 for the call."""
        def call(x):
            cuda_bp.SMEM_LIMIT_BYTES = 0
            try:
                return run(x)
            finally:
                cuda_bp.SMEM_LIMIT_BYTES = limit
        return call

    reset_launches()
    outs = [run(llr) for run in (run_off, scratch_lp(run_off), run_on,
                                 scratch_lp(run_on))]
    torch.cuda.synchronize()
    if (_diff(outs[0], outs[1])[0] or _diff(outs[2], outs[3])[0]
            or LAUNCHES["minsum_flood_gmem_smem"] != 2):
        raise AssertionError("[gmem] the placements of L and P differ")
    k1 = _cuda_time_ms(lambda: run_off(llr), 5)
    s1 = _cuda_time_ms(lambda: scratch_lp(run_off)(llr), 5)
    p_ms = _cuda_time_ms(lambda: plain_off(llr), 1)
    s2 = _cuda_time_ms(lambda: scratch_lp(run_off)(llr), 5)
    k2 = _cuda_time_ms(lambda: run_off(llr), 5)
    k_on = _cuda_time_ms(lambda: run_on(llr), 5)
    s_on = _cuda_time_ms(lambda: scratch_lp(run_on)(llr), 5)
    k_ms, s_ms = (k1 + k2) / 2, (s1 + s2) / 2
    bound, by = _bound_ms(code, b, "minsum", b * 50)
    bound_on, by_on = _bound_ms(code, b, "minsum", iters_on)
    print(f"[gmem time] minsum_flood_gmem {code.name} b={b} 50 it ET off: "
          f"L and P in shared memory {k_ms:.4f} ms/batch ({k1:.4f}, "
          f"{k2:.4f}), in the scratch {s_ms:.4f} ms/batch ({s1:.4f}, "
          f"{s2:.4f}); bound {bound:.5f} ms ({by}, {bound / k_ms:.3%} / "
          f"{bound / s_ms:.3%} of them); plain {p_ms:.4f} ms; {ebn0} dB ET "
          f"on (mean iters {iters_on / b:.4f}): {k_on:.4f} / {s_on:.4f} ms, "
          f"bound {bound_on:.5f} ms ({by_on}); {smi}")
    return {"name": "minsum_flood_gmem", "route": "cuda",
            "source": SRC + "bp_flood.cu",
            "replaces": PALLAS + "514 flooding kernel, state beyond one "
                                 "block's shared memory",
            "launches": launches["minsum_flood_gmem"], "max_abs_err": err,
            "ms": k_ms, "ms_scratch_lp": s_ms, "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "shape": [code.name, b, ebn0]}


def _slice12_path(dev, smi):
    """The registry tools in this process: the timing script's
    measurement of SLICE12_CELLS (single-pass layered ET, layered-25 and
    flooding-50 ET off on the same buffers), measure_at against measure on
    the judged timer (its buffers first rebuilt on the card and held
    equal to the timer's own bit for bit), the audit's fits over those
    rows, and one IR-HARQ point of the HARQ twin (stage FERs equal a
    second run_irharq of the same seed).  Returns the timing script's rows
    by cell and the timer check."""
    import torch

    from tpu_ldpc_torch.benchcore import make_timer
    from tpu_ldpc_torch.channel.awgn import noise_sigma2
    from tpu_ldpc_torch.codes.nrlike import KB, KB2
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
    from tpu_ldpc_torch.sim.harq import run_irharq

    t0 = time.perf_counter()
    tune = _load_script("torch_tune_registry_knobs")
    audit = _load_script("torch_roofline_audit")
    harq = _load_script("torch_irharq")
    print(f"[slice12] nvidia-smi: {smi}")
    cells = {code.name: (code, ebn0) for code, ebn0 in tune.cells()}
    rows = {}
    for cname in SLICE12_CELLS:
        code, ebn0 = cells[cname]
        row = tune.measure_cell(code, ebn0, dev, BATCH, SLICE12_REPS)
        if "skipped" in row:
            raise AssertionError(f"[slice12] {cname}: {row}")
        rows[cname] = row
        print(f"[slice12] {cname} {ebn0} dB b={BATCH}: ms a batch: layered "
              f"25 ET {row['single_et_ms']:.4f} (mean iters "
              f"{row['single_et_mean_iters']:.3f}), layered 25 ET off "
              f"{row['layered_etoff_ms']:.4f}, flooding 50 ET off "
              f"{row['flood_etoff_ms']:.4f}; wall {row['wall_s']} s")

    judged, ebn0 = cells["qc1024_r12"]
    timer = make_timer(judged, BATCH, ebn0, device=dev)
    k1 = build_cuda_decoder(judged, "minsum", 50, 0.75, 0.0, "flooding",
                            False, normalize=False)
    # move the timer to the HARQ point's channel and back, so that
    # measure_at below times buffers rebuilt on the card at the timer's
    # own point; they must equal the timer's own LLRs bit for bit
    bg, harq_ebn0 = SLICE12_HARQ
    sigma2 = noise_sigma2(harq_ebn0, harq.first_rate(
        KB if bg == 1 else KB2, harq.LADDERS[bg]["stage_m"], harq.Z))
    away = timer.buffers_at(2.0 / sigma2, math.sqrt(sigma2))
    rebuilt = timer.buffers_at(timer.scale, timer.sig)
    if any(torch.equal(a, b) for a, b in zip(away, timer.llrs)) or any(
            a is b for a, b in zip(rebuilt, timer.llrs)) or not all(
            torch.equal(a, b) for a, b in zip(rebuilt, timer.llrs)):
        raise AssertionError("[slice12] buffers_at at the timer's point "
                             "does not rebuild its LLRs bit for bit")
    print(f"[slice12] judged timer: {len(rebuilt)} buffers rebuilt on the "
          f"card at its own point (after the HARQ point's) == its LLRs bit "
          f"for bit")
    own = [timer.measure(k1, SLICE12_REPS)["median_s"],
           timer.measure_at(k1, timer.scale, timer.sig,
                            SLICE12_REPS)["median_s"]]
    own += [timer.measure_at(k1, timer.scale, timer.sig,
                             SLICE12_REPS)["median_s"],
            timer.measure(k1, SLICE12_REPS)["median_s"]]
    ratio = (own[1] + own[2]) / (own[0] + own[3])
    print(f"[slice12] judged K1 ET off: measure_at at the timer's point "
          f"{(own[1] + own[2]) / 2 * 1e3:.4f} ms, measure "
          f"{(own[0] + own[3]) / 2 * 1e3:.4f} ms (ratio {ratio:.4f}, band "
          f"{SLICE12_BAND})")
    if abs(ratio - 1) > SLICE12_BAND:
        raise AssertionError(f"measure_at {own[1:3]} s is not within "
                             f"{SLICE12_BAND:.0%} of measure {own[::3]} s")

    audit_rows, fits = audit.audit(rows)
    for r in audit_rows:
        iters = 25 if r["fit"] == "layered_etoff" else 50
        if r["edge_iters_per_frame"] != r["E_lifted"] * iters:
            raise AssertionError(f"[slice12] audit row {r}")
    for label, ((c1, c2, c3), ok) in fits.items():
        print(f"[slice12] audit {label}: ps/edge = {1e12 * c1:.3f} + "
              f"{1e12 * c2:.3f}*[Z%8!=0] + {1e12 * c3:.4f}*rowdeg over "
              f"{len(ok)} cells; " + ", ".join(
                  f"{r['cell']} bucket {r['bucket']} {r['ps_per_edge']} ps "
                  f"({r['residual_pct']:+.1f}%)" for r in ok))

    bg, ebn0 = SLICE12_HARQ
    spec = harq.LADDERS[bg]
    stages = harq.StageTimer(bg, spec["stage_m"], harq.Z, BATCH, dev,
                             SLICE12_REPS)
    point = harq.run_point(bg, spec, ebn0, stages, harq.Z, BATCH, dev)
    again = run_irharq(Z=harq.Z, stage_m=spec["stage_m"], ebn0_db=ebn0,
                       batch=BATCH, iters=harq.ITERS, alpha=harq.ALPHA,
                       seed=harq.SEED, bg=bg, crc=harq.CRC, device=dev)
    if point["stages"] != again.stages:
        raise AssertionError(f"[slice12] HARQ stages {point['stages']} != "
                             f"{again.stages}")
    gbps = (point["eff_info_gbps_active_batching"],
            point["eff_info_gbps_full_vector"])
    if not all(g is not None and math.isfinite(g) and g > 0 for g in gbps):
        raise AssertionError(f"[slice12] HARQ throughput {gbps}")
    print(f"[slice12] HARQ bg{bg} {ebn0} dB b={BATCH}: stage FERs "
          f"{[s['fer_after'] for s in point['stages']]} == a second "
          f"run_irharq; stage ms a batch "
          f"{[round(s['ms_per_batch'], 4) for s in point['stage_timing']]} "
          f"(occupancy {[s['occ'] for s in point['stage_timing']]}); "
          f"delivered {gbps[0]:.4f} Gb/s active-set, {gbps[1]:.4f} Gb/s "
          f"full vector; run_irharq {point['harq_wall_s']} s")
    torch.cuda.synchronize()
    print(f"[slice12] wall {time.perf_counter() - t0:.2f} s")
    return {"rows": rows, "measure_at_ratio": ratio}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA "
              "device, nothing to test", file=sys.stderr)
        return 1
    import numpy as np

    from tpu_ldpc_torch import LdpcCode, _build, benchcore
    from tpu_ldpc_torch.cli import sim as cli_sim
    from tpu_ldpc_torch.cli.config import ChannelCfg, CodeSpec
    from tpu_ldpc_torch.decode import decode
    from tpu_ldpc_torch.decode.cuda_bp import (
        LAUNCHES, build_cuda_decoder, reset_launches)
    from tpu_ldpc_torch.codes.base_graphs import (
        FAMILY_LIFTS, make_sc_base_graph)
    from tpu_ldpc_torch.encode.encoder import build_encoder
    from tpu_ldpc_torch.sim.harq import run_irharq
    from tpu_ldpc_torch.decode.flood_plan import compressed_plan, flood_plan
    from tpu_ldpc_torch.decode.layered_plan import layered_plan
    from tpu_ldpc_torch.decode.normalize import coordinates
    from tpu_ldpc_torch.decode.reference import build_decoder
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step, run_ber

    rows = {row[0]: row for row in KERNELS}
    modes = {name: {k: torch.bfloat16 if v == "bf16" else v
                    for k, v in mode.items()}
             for name, *_, mode in KERNELS}

    def kernel(kname, code, iters, early_stop, **extra):
        """The decoder of KERNELS row `kname` (its mode, then `extra`)."""
        _, algo, sched, *_ = rows[kname]
        return build_cuda_decoder(code, algo, iters, 0.75, 0.0, sched,
                                  early_stop, **{**modes[kname], **extra})

    def plain(kname, code, iters, early_stop, **extra):
        """The plain version of the same decoder."""
        _, algo, sched, *_ = rows[kname]
        return build_decoder(code, algo, iters, 0.75, 0.0, sched, early_stop,
                             **{**modes[kname], **extra})

    # ---- 1. device --------------------------------------------------------
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = benchcore.smi()
    print(f"[1 device] {name} capability={cap} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"[1 device] nvidia-smi: {smi}")
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a, card is sm_{cap}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build (one nvcc per source, in parallel) ----------------------
    t0 = time.perf_counter()
    _build.load_all()
    print(f"[2 build] {sorted(_build.sources())} in "
          f"{time.perf_counter() - t0:.2f} s")
    judged_seen = [0] * len(JUDGED_INSTANTIATIONS)
    for src, log in sorted(_build.build_log.items()):
        for kname, regs, spills in _ptxas_report(log):
            inst = _instantiation(kname)
            print(f"[2 build] {src} ptxas: {inst}: {regs} "
                  f"registers, {spills} bytes spill stores + loads")
            for k, (head, tail, _) in enumerate(JUDGED_INSTANTIATIONS):
                if inst.startswith(head) and inst.endswith(tail):
                    judged_seen[k] += 1
                    if spills:
                        raise AssertionError(f"{inst}: ptxas spills "
                                             f"{spills} B")
    for (head, tail, count), seen in zip(JUDGED_INSTANTIATIONS, judged_seen):
        if seen != count:
            raise AssertionError(
                f"ptxas reports {seen} of the {count} judged-code "
                f"instantiations {head}...{tail} (delete build/ to rebuild)")
    print(f"[2 build] the judged code's {sum(judged_seen)} instantiations "
          "(flooding, layered and compressed): no spill")

    # ---- 3. kernels vs plain versions on the card --------------------------
    t_phase = time.perf_counter()
    judged = LdpcCode.judged()
    min_sum_cases = [  # (code, Eb/N0 in its waterfall, batches)
        (judged, 2.0, (4096, 4097)),
        (LdpcCode.from_family("wifi", "2/3", 27), 2.0, (4096,)),   # odd Z
        (LdpcCode.from_family("wimax", "5/6", 96), 3.0, (4096,)),  # row deg 19
    ]
    max_abs_err = {kname: 0 for kname, *_ in KERNELS}
    agreement = {kname: 1.0 for kname, *_ in KERNELS}
    for kname, algo, sched, iters, *_ in KERNELS[:2]:  # min-sum: bit-exact
        for ci, (code, ebn0, batches) in enumerate(min_sum_cases):
            base = _noisy_llrs(code, max(batches), ebn0, SEED + ci)
            inputs = [(f"{ebn0} dB b={b}", base[:b]) for b in batches]
            inputs.append(("+-0.0/1e4 b=1024",
                           _special_llrs(base[:1024], SEED)))
            for label, llr_np in inputs:
                llr = torch.from_numpy(np.ascontiguousarray(llr_np)).to(dev)
                for et in (True, False):
                    got = kernel(kname, code, iters, et)(llr)
                    want = plain(kname, code, iters, et)(llr)
                    torch.cuda.synchronize()
                    err, _ = _diff(got, want)
                    max_abs_err[kname] = max(max_abs_err[kname], err)
                    if err:
                        raise AssertionError(
                            f"{kname} {code.name} {label} et={et}: kernel != "
                            f"plain (max |diff| {err})")
                    print(f"[3 kernel==plain] {kname} {code.name} {label} "
                          f"et={et}: bit-exact, "
                          f"ok={float(got[1].float().mean()):.4f} "
                          f"mean_iters={float(got[2].double().mean()):.3f}")
    for si, ebn0 in enumerate(SP_EBN0):
        sp_llr = torch.from_numpy(
            _noisy_llrs(judged, BATCH, ebn0, SEED + 5 + si)).to(dev)
        # sum-product, f32 and bf16 messages (K3 and K3 under K7); the
        # control: the min-sum kernel of the same storage
        for kname, algo, sched, iters, *_ in (KERNELS[2:4]
                                              + KERNELS[11:13]):
            for et in (True, False):
                got = kernel(kname, judged, iters, et)(sp_llr)
                want = plain(kname, judged, iters, et)(sp_llr)
                err, share = _diff(got, want)
                max_abs_err[kname] = max(max_abs_err[kname], err)
                agreement[kname] = min(agreement[kname], share)
                ms = build_cuda_decoder(judged, "minsum", iters, 0.75, 0.0,
                                        sched, et, **modes[kname])(sp_llr)
                _, ms_share = _diff(ms, want)
                print(f"[3 kernel~plain] {kname} judged {ebn0} dB b={BATCH} "
                      f"et={et}: frame agreement {share:.6f} (>= "
                      f"{SP_MIN_AGREEMENT}), max |diff| {err}, "
                      f"ok={float(got[1].float().mean()):.4f}; control: "
                      f"the min-sum kernel agrees on {ms_share:.6f}")
                if share < SP_MIN_AGREEMENT:
                    raise AssertionError(f"{kname} {ebn0} dB et={et}: frame "
                                         f"agreement {share} < "
                                         f"{SP_MIN_AGREEMENT}")
                if ms_share >= SP_MIN_AGREEMENT:
                    raise AssertionError(f"{kname} {ebn0} dB et={et}: the "
                                         f"check passes min-sum "
                                         f"({ms_share})")

    # sumproduct-fast and fixed-point min-sum on the three codes, and the
    # bit-exact slice-4 modes on the judged code (compressed state needs
    # row degree <= 8): K6, K7 with min-sum and sumproduct-fast, K8.
    # Bit-exact, both schedules; the 4-bit grid has a control: the float
    # min-sum kernel on the same LLRs must not match the quantized plain
    # version
    bases = {code.name: _noisy_llrs(code, BATCH, ebn0, SEED + ci)
             for ci, (code, ebn0, _) in enumerate(min_sum_cases)}
    Q4 = {"quant_bits": 4, "quant_step": 0.5}
    cases = [(kname, {}, min_sum_cases) for kname in ("spfast_flood",
                                                      "spfast_layered")]
    cases += [(kname, q, min_sum_cases) for kname in (
        "minsum_quant_flood", "minsum_quant_layered") for q in (Q6, Q4)]
    cases += [(kname, {}, min_sum_cases[:1]) for kname in (
        "minsum_compressed_flood", "minsum_flood_bf16", "minsum_layered_bf16",
        "spfast_flood_bf16", "spfast_layered_bf16", "minsum_rescaled_flood")]
    for kname, q, codes in cases:
        sched, iters = rows[kname][2], rows[kname][3]
        for code, ebn0, _ in codes:
            base = bases[code.name]
            for label, llr_np in ((f"{ebn0} dB b={BATCH}", base),
                                  ("+-0.0/1e4 b=1024",
                                   _special_llrs(base[:1024], SEED))):
                llr = torch.from_numpy(np.ascontiguousarray(llr_np)).to(dev)
                for et in (True, False):
                    got = kernel(kname, code, iters, et, **q)(llr)
                    want = plain(kname, code, iters, et, **q)(llr)
                    torch.cuda.synchronize()
                    err, _ = _diff(got, want)
                    max_abs_err[kname] = max(max_abs_err[kname], err)
                    what = f"{kname} {q or ''} {code.name} {label} et={et}"
                    if err:
                        raise AssertionError(f"{what}: kernel != plain "
                                             f"(max |diff| {err})")
                    control = ""
                    if q.get("quant_bits") == 4:
                        fl = build_cuda_decoder(code, "minsum", iters, 0.75,
                                                0.0, sched, et, **PLAIN)(llr)
                        c_err, c_share = _diff(fl, want)
                        if not c_err:
                            raise AssertionError(
                                f"{what}: the float min-sum kernel matches "
                                "the 4-bit plain version")
                        control = (f"; control: float min-sum agrees on "
                                   f"{c_share:.6f} of frames")
                    print(f"[3 kernel==plain] {what}: bit-exact, "
                          f"ok={float(got[1].float().mean()):.4f} "
                          f"mean_iters="
                          f"{float(got[2].double().mean()):.3f}{control}")

    # shift normalization (K9) on against off for K1, K2, K4 and K5, the
    # three codes, ET on and off; the normalized K1 / K2 also against
    # their plain version (normalize=True) on the judged code
    for kname in ("minsum_flood", "minsum_layered", "spfast_flood",
                  "minsum_quant_layered"):
        iters = rows[kname][3]
        row = kname + "_normalized"
        for code, ebn0, _ in min_sum_cases:
            base = bases[code.name]
            for label, llr_np in ((f"{ebn0} dB b={BATCH}", base),
                                  ("+-0.0/1e4 b=1024",
                                   _special_llrs(base[:1024], SEED))):
                llr = torch.from_numpy(np.ascontiguousarray(llr_np)).to(dev)
                for et in (True, False):
                    on = kernel(kname, code, iters, et, normalize=True)
                    got = on(llr)
                    err, _ = _diff(got, kernel(kname, code, iters, et)(llr))
                    if row in rows and code is judged and label[0] != "+":
                        p_err, _ = _diff(got, plain(kname, code, iters, et,
                                                    normalize=True)(llr))
                        err = max(err, p_err)
                    if row in max_abs_err:
                        max_abs_err[row] = max(max_abs_err[row], err)
                    what = f"{kname} normalized {code.name} {label} et={et}"
                    if err:
                        raise AssertionError(f"{what}: != unnormalized "
                                             f"(max |diff| {err})")
                    print(f"[3 K9 on==off] {what}: bit-exact, "
                          f"{sum(s == 0 for s in coordinates(code, True)[0])}"
                          f" of {code.layout.E} shifts 0 (unnormalized "
                          f"{sum(s == 0 for s in coordinates(code, False)[0])}"
                          ")")

    # the flooding and layered bodies' instantiations by row-degree bucket
    # (kMaxDeg, decode/flood_plan.py and decode/layered_plan.py): the
    # codes above cover 8 (judged), 16 (wifi 2/3) and 32 (wimax 5/6 Z=96);
    # here the largest row of each bucket, wifi 3/4 Z=27 (16 of 16) and
    # wimax 5/6 Z=48 (20 of 32); the flooding two-pass kernel (kMaxDeg =
    # 0) on wimax 1/2 Z=96 (1152 checks, more than a one-pass block holds)
    # and the layered and flooding two-pass forms on a row of degree 40;
    # an SC chain of 2176 checks (K6's walking form, flooding kMaxDeg 0)
    # and one whose layered index table does not fit beside its state
    # (the layered two-pass form at Z=96, 66 block-rows, whose flooding
    # state no longer fits a block).  Bit-exact modes, ET on and off; K6
    # also against the float32 K1 where K1's state fits
    wide_B = np.full((2, 40), -1)
    wide_B[0, :] = np.arange(40) % 5
    wide_B[1, :4] = [1, 2, 3, 4]
    every = (("minsum_flood", {}), ("spfast_flood", {}),
             ("minsum_quant_flood", Q6), ("minsum_flood_bf16", {}),
             ("minsum_rescaled_flood", {}), ("minsum_layered", {}),
             ("spfast_layered", {}), ("minsum_quant_layered", Q6),
             ("minsum_layered_bf16", {}), ("spfast_layered_bf16", {}))
    bucket_cases = [  # (code, Eb/N0, batch, kernels)
        (LdpcCode.from_family("wifi", "3/4", 27), 2.5, 1024, every),
        (LdpcCode.from_family("wimax", "5/6", 48), 3.0, 1024, every),
        (LdpcCode.from_family("wimax", "1/2", 96), 2.0, 1024, every),
        (LdpcCode.from_base_graph(wide_B, 5, "deg40"), 4.0, 1024, every),
        (LdpcCode.from_base_graph(make_sc_base_graph(32, 64), 64,
                                  "sc_l32_z64"), 2.0, 256,
         (("minsum_layered", {}), ("minsum_quant_layered", Q6),
          ("minsum_compressed_flood", {}))),
        (LdpcCode.from_base_graph(make_sc_base_graph(64, 96), 96,
                                  "sc_l64_z96"), 2.0, 128,
         (("minsum_layered", {}), ("minsum_layered_bf16", {}),
          ("minsum_compressed_flood", {}))),
    ]
    for ci, (code, ebn0, batch, knames) in enumerate(bucket_cases):
        if code.name in ("deg40",) or code.name.startswith("sc_"):
            # rank-deficient H (or no encoder needed): the zero codeword
            rng = np.random.default_rng(SEED + 20)
            sigma2 = 1.0 / (2 * 0.5 * 10 ** (ebn0 / 10))
            base = (2.0 / sigma2 * (1.0 + np.sqrt(sigma2) * rng.normal(
                size=(batch, code.n)))).astype(np.float32)
        else:
            base = _noisy_llrs(code, batch, ebn0, SEED + 20 + ci)
        shifts = coordinates(code, False)[0]
        for label, llr_np in ((f"{ebn0} dB", base),
                              ("+-0.0/1e4", _special_llrs(base, SEED))):
            llr_all = torch.from_numpy(np.ascontiguousarray(llr_np)).to(dev)
            for kname, q in knames:
                sched, iters = rows[kname][2], rows[kname][3]
                # the layered kernels on the first 512 frames (phase 3's
                # wall time is mostly the plain versions)
                llr = llr_all[:512] if sched == "layered" else llr_all
                if kname == "minsum_compressed_flood":
                    cp = compressed_plan(code)
                    form = (f"one check a thread={int(cp.one_check)} "
                            f"threads={cp.threads}")
                elif sched == "layered":
                    lp, lp_et = (layered_plan(code, shifts,
                                              2 if "bf16" in kname else 4, et)
                                 for et in (False, True))
                    form = (f"kMaxDeg={lp.bucket} group={lp.group} "
                            f"(ET on {lp_et.group}) threads={lp.threads}")
                else:
                    fp = flood_plan(code, shifts)
                    form = f"kMaxDeg={fp.bucket} threads={fp.threads}"
                for et in (True, False):
                    got = kernel(kname, code, iters, et, **q)(llr)
                    want = plain(kname, code, iters, et, **q)(llr)
                    err, _ = _diff(got, want)
                    vs_k1 = (kname == "minsum_compressed_flood"
                             and code.name != "sc_l64_z96")
                    if vs_k1:
                        err = max(err, _diff(got, kernel(
                            "minsum_flood", code, iters, et)(llr))[0])
                    max_abs_err[kname] = max(max_abs_err[kname], err)
                    what = (f"{kname} {code.name} {form} {label} "
                            f"b={llr.shape[0]} et={et}")
                    if err:
                        raise AssertionError(f"{what}: kernel != plain "
                                             f"(max |diff| {err})")
                    print(f"[3 bucket] {what}: bit-exact"
                          f"{' (and == K1)' if vs_k1 else ''}"
                          f", ok={float(got[1].float().mean()):.4f} "
                          f"mean_iters={float(got[2].double().mean()):.3f}")
    # slice 7: the NR-like mothers (bucket 0, the two-pass forms) with
    # punctured LLRs, +0.0 on two blocks of every frame, at their
    # frozen rows' Eb/N0: K1 and K2, ET on and off, 1024 frames
    nr_codes = [(CodeSpec(family=family, rate=rate, Z=64).build(), ebn0)
                for (family, rate), (ebn0, _, _) in NR_ROWS.items()]
    for ci, (code, ebn0) in enumerate(nr_codes):
        llr = _punctured_llrs(code, 1024, ebn0, SEED + 30 + ci).to(dev)
        shifts = coordinates(code, False)[0]
        for kname in ("minsum_flood", "minsum_layered"):
            sched, iters = rows[kname][2], rows[kname][3]
            for et in (True, False):
                form = (f"kMaxDeg={layered_plan(code, shifts, 4, et).bucket}"
                        if sched == "layered"
                        else f"kMaxDeg={flood_plan(code, shifts).bucket}")
                got = kernel(kname, code, iters, et)(llr)
                err, _ = _diff(got, plain(kname, code, iters, et)(llr))
                max_abs_err[kname] = max(max_abs_err[kname], err)
                what = (f"{kname} {code.name} {form} punctured {ebn0} dB "
                        f"b=1024 et={et}")
                if err:
                    raise AssertionError(f"{what}: kernel != plain (max "
                                         f"|diff| {err})")
                print(f"[3 nr] {what}: bit-exact, "
                      f"ok={float(got[1].float().mean()):.4f} "
                      f"mean_iters={float(got[2].double().mean()):.3f}")
    # slice 9: K1 on the census's first chunk, K3 on the impulse probes
    err_k1, err_k3, share, chunk0, probe = _slice9_kernels(dev, kernel,
                                                           plain)
    max_abs_err["minsum_flood"] = max(max_abs_err["minsum_flood"], err_k1)
    max_abs_err["sumproduct_flood"] = max(max_abs_err["sumproduct_flood"],
                                          err_k3)
    agreement["sumproduct_flood"] = min(agreement["sumproduct_flood"], share)
    print(f"[3] wall {time.perf_counter() - t_phase:.2f} s")

    # ---- 4. main paths (counts set to 0 before each, read after) ----------
    os.makedirs(OUT_DIR, exist_ok=True)
    llr = torch.from_numpy(_noisy_llrs(judged, BATCH, 2.0, SEED + 10)).to(dev)
    launches = {kname: 0 for kname, *_ in KERNELS}

    def check_decode_outputs(out, what):
        bits, ok, iters_used = out
        if not (bits.shape == (BATCH, judged.n) and bits.dtype == torch.uint8
                and ok.shape == (BATCH,) and ok.dtype == torch.bool
                and iters_used.dtype == torch.int32):
            raise AssertionError(f"{what}: output shapes / dtypes")

    def slice1_path():
        """Flooding min-sum: decode(), run_ber, regrouping, the CLI."""
        out = decode(judged, llr)
        torch.cuda.synchronize()
        check_decode_outputs(out, "decode()")
        pb, pok, piu = decode(judged, llr[:256].cpu())  # the plain version
        if not (torch.equal(out[0][:256].cpu(), pb)
                and torch.equal(out[1][:256].cpu(), pok)
                and torch.equal(out[2][:256].cpu(), piu)):
            raise AssertionError("decode() on the card != decode() on the "
                                 "CPU (256 rows)")
        print(f"[4 decode] judged flooding min-sum b={BATCH} "
              f"ok={float(out[1].float().mean()):.4f}")
        _run_ber_check(run_ber, judged, DecodeCfg(), "minsum flooding 50", 0)
        step1 = build_mc_step(judged, DecodeCfg(), BATCH, 1, device="cuda")
        step4 = build_mc_step(judged, DecodeCfg(), BATCH, 4, device="cuda")
        c1 = sum(np.asarray(step1(0, 0, 2.0, t).tolist()) for t in range(4))
        c4 = np.asarray(step4(0, 0, 2.0, 0).tolist())
        if not np.array_equal(c1, c4):
            raise AssertionError(f"steps_per_call 1 vs 4: {c1} != {c4}")
        print(f"[4 regroup] steps_per_call 1 == 4 over 4 batches: "
              f"{c4.tolist()}")
        csv = os.path.join(OUT_DIR, "judged_2db.csv")
        cli_sim.main(["--family", "judged", "--ebn0", "2.0", "--device",
                      "cuda", "--batch", "2048", "--max-frames", "16384",
                      "--csv", csv])
        with open(csv) as f:
            row = f.read().strip().splitlines()[-1].split(",")
        if int(row[1]) < 16384:
            raise AssertionError(f"CLI CSV row {row}")
        print(f"[4 cli] wrote {csv}: frames={row[1]} FER={row[7]}")

    slice10 = {}
    slice11 = {}
    slice12 = {}

    def slice2_path():
        """Layered min-sum and exact sum-product: decode() and
        run_ber."""
        for kw in (dict(schedule="layered", iters=25),
                   dict(algo="sumproduct", schedule="layered", iters=25)):
            out = decode(judged, llr, **kw)
            torch.cuda.synchronize()
            check_decode_outputs(out, f"decode({kw})")
            plain = decode(judged, llr[:256].cpu(), **kw)
            err, share = _diff([x[:256].cpu() for x in out], plain)
            if kw.get("algo") == "sumproduct":
                # the CPU rounds tanh / log otherwise: the golden contract
                # of the CPU tests; the full batch against the plain
                # version on the card is held to SP_MIN_AGREEMENT
                card_plain = build_decoder(judged, "sumproduct", 25,
                                           schedule="layered")(llr)
                _, card_share = _diff(out, card_plain)
                print(f"[4 decode] judged {kw} b={BATCH}: kernel vs plain "
                      f"on the card: agreement {card_share:.6f}")
                if share < 0.97 or card_share < SP_MIN_AGREEMENT:
                    raise AssertionError(
                        f"decode({kw}): frame agreement {share} with the "
                        f"CPU, {card_share} with the card's plain version")
            elif err:
                raise AssertionError(f"decode({kw}) on the card != on the "
                                     "CPU (256 rows)")
            print(f"[4 decode] judged {kw} b={BATCH} "
                  f"ok={float(out[1].float().mean()):.4f} "
                  f"mean_iters={float(out[2].double().mean()):.3f} "
                  f"card vs CPU (256 rows): agreement {share:.4f}")
        _run_ber_check(run_ber, judged, DecodeCfg(schedule="layered",
                                                  iters=25),
                       "minsum layered 25", 1)
        _run_ber_check(run_ber, judged, DecodeCfg(algo="sumproduct"),
                       "sumproduct flooding 50", 2)

    def slice3_path():
        """sumproduct-fast and fixed-point min-sum: decode() on both
        schedules, run_ber against the frozen quantized rows, the CLI's
        Eb/N0-at-FER search."""
        for kw in (dict(algo="sumproduct-fast"),
                   dict(algo="sumproduct-fast", schedule="layered", iters=25),
                   dict(Q6),
                   dict(Q6, schedule="layered", iters=25)):
            out = decode(judged, llr, **kw)
            torch.cuda.synchronize()
            check_decode_outputs(out, f"decode({kw})")
            plain = decode(judged, llr[:256].cpu(), **kw)
            err, _ = _diff([x[:256].cpu() for x in out], plain)
            if err:
                raise AssertionError(f"decode({kw}) on the card != on the "
                                     "CPU (256 rows)")
            print(f"[4 decode] judged {kw} b={BATCH} "
                  f"ok={float(out[1].float().mean()):.4f} "
                  f"mean_iters={float(out[2].double().mean()):.3f}: "
                  "bit-exact with decode(device='cpu') on 256 rows")
        for si, (label, (bits, step, errs, frames, run)) in enumerate(
                QUANT_ROWS_2DB.items()):
            _run_ber_check(run_ber, judged,
                           DecodeCfg(quant_bits=bits, quant_step=step),
                           f"minsum {label} flooding 50", 3 + si, frames=run,
                           ref=_wilson_interval(errs, frames))
        # the search alone must run K4 and not K3: its counts are set to 0
        # just before it, read apart, then added back to the path's
        before = dict(LAUNCHES)
        reset_launches()
        t0 = time.perf_counter()
        sr = cli_sim.main(["--family", "judged", "--algo", "sumproduct-fast",
                           "--find-fer", "1e-2", "--ebn0", "1.5", "2.5",
                           "--target-fe", "120", "--batch", str(BATCH),
                           "--device", "cuda"])
        torch.cuda.synchronize()
        search = {kname: n for kname, n in LAUNCHES.items() if n}
        for kname in LAUNCHES:
            LAUNCHES[kname] += before[kname]
        print(f"[4 find-fer] launches of the search alone: {search}")
        if (search.get("spfast_flood", 0) < 1
                or search.get("sumproduct_flood", 0) != 0
                or set(search) - {"spfast_flood", "spfast_flood_normalized"}):
            raise AssertionError(f"find-fer for sumproduct-fast launched "
                                 f"{search}, not spfast_flood alone")
        print(f"[4 find-fer] judged sumproduct-fast flooding 50 it: Eb/N0 at "
              f"FER 1e-2 {sr.ebn0_db:.4f} dB, bracket "
              f"[{sr.bracket[0]:.4f}, {sr.bracket[1]:.4f}], "
              f"{len(sr.probes)} probes, "
              f"{sum(p.frames for p in sr.probes)} frames, wall "
              f"{time.perf_counter() - t0:.2f} s; frozen (jnp, CPU): "
              f"sumproduct-fast {SPFAST_AT_FER_DB}, sumproduct "
              f"{SP_AT_FER_DB}, min-sum {MINSUM_AT_FER_DB}")
        if not (sr.converged
                and abs(sr.ebn0_db - SPFAST_AT_FER_DB) <= SPFAST_BAND_DB):
            raise AssertionError(
                f"find-fer: {sr.ebn0_db} dB (converged {sr.converged}) is "
                f"not within {SPFAST_BAND_DB} dB of {SPFAST_AT_FER_DB}")

    def slice4_path():
        """build_cuda_decoder's storage and arithmetic modes on the judged
        code at 2.0 dB, b=4096, ET on: compressed state equal to the
        float32 kernel, rescaled and bf16 min-sum within its >= 0.97 frame
        contract, every CN update and schedule under bf16, normalized
        against plain coordinates, decode() in the code's own
        coordinates."""
        bf16 = torch.bfloat16
        ref = build_cuda_decoder(judged, "minsum", 50, normalize=False)(llr)

        def fer(out):
            return 1.0 - float(out[1].double().mean())

        def contract(out, want):
            """(share of frames with equal bits, share with equal ok)."""
            return (float((out[0] == want[0]).all(dim=1).double().mean()),
                    float((out[1] == want[1]).double().mean()))

        out = build_cuda_decoder(judged, "minsum", 50, compressed=True)(llr)
        if _diff(out, ref)[0]:
            raise AssertionError("compressed row state != float32 min-sum")
        print(f"[4 modes] judged flooding min-sum 50 it 2.0 dB b={BATCH}: "
              f"compressed state bit-identical to the float32 kernel, FER "
              f"{fer(out):.4e}")
        for what, kw in (("rescaled", dict(rescaled=True)),
                         ("bf16 messages", dict(msg_dtype=bf16))):
            out = build_cuda_decoder(judged, "minsum", 50, **kw)(llr)
            share = contract(out, ref)
            print(f"[4 modes] judged flooding min-sum 50 it {what}: agrees "
                  f"with the float32 kernel on {share[0]:.6f} of frames' "
                  f"bits and {share[1]:.6f} of ok; FER {fer(out):.4e} "
                  f"against {fer(ref):.4e}")
            if min(share) < 0.97:
                raise AssertionError(f"{what}: {share} < 0.97")
        for algo in ("minsum", "sumproduct", "sumproduct-fast"):
            for sched, iters in (("flooding", 50), ("layered", 25)):
                f32 = build_cuda_decoder(judged, algo, iters,
                                         schedule=sched)(llr)
                out = build_cuda_decoder(judged, algo, iters, schedule=sched,
                                         msg_dtype=bf16)(llr)
                share = contract(out, f32)
                print(f"[4 modes] judged {algo} {sched} {iters} it bf16: "
                      f"agrees with float32 on {share[0]:.6f} / "
                      f"{share[1]:.6f} (bits / ok); FER {fer(out):.4e} "
                      f"against {fer(f32):.4e}")
                if min(share) < 0.97:
                    raise AssertionError(f"{algo} {sched} bf16: {share}")
        for sched, iters in (("flooding", 50), ("layered", 25)):
            on = build_cuda_decoder(judged, "minsum", iters, schedule=sched)
            off = build_cuda_decoder(judged, "minsum", iters, schedule=sched,
                                     normalize=False)
            if _diff(on(llr), off(llr))[0]:
                raise AssertionError(f"normalized {sched} != unnormalized")
            print(f"[4 modes] judged min-sum {sched} {iters} it: normalized "
                  f"== unnormalized")
        norm = build_cuda_decoder(judged, "minsum", 50)(llr)
        before = dict(LAUNCHES)
        out = decode(judged, llr)
        if (LAUNCHES["minsum_flood"] != before["minsum_flood"] + 1
                or LAUNCHES["minsum_flood_normalized"]
                != before["minsum_flood_normalized"] or _diff(out, norm)[0]):
            raise AssertionError("decode() did not run K1 in the code's own "
                                 "coordinates or differs from the "
                                 "normalized kernel")
        print("[4 modes] decode(): K1 in the code's own coordinates, "
              "bit-identical to the normalized kernel")

    def slice7_path():
        """The rate-compatible transmission path: the dual-diagonal
        encoder on every registry cell it accepts, run_ber on the
        punctured NR-like mothers against their frozen rows, both arms
        of the CRC run, IR-HARQ (kernel against plain, and against the
        JAX run's stages) and the CLI with --family nr --crc."""
        import contextlib
        import dataclasses
        import io

        cells = [judged] + [LdpcCode.from_family(fam, rate, Z)
                            for fam in ("wifi", "wimax")
                            for rate in ("1/2", "2/3", "3/4", "5/6")
                            for Z in FAMILY_LIFTS[fam]]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        for code in cells:
            dd = build_encoder(code, "dual_diagonal", device=dev)
            u = torch.randint(0, 2, (BATCH, code.k), generator=gen,
                              device=dev, dtype=torch.uint8)
            if not torch.equal(dd(u), build_encoder(code, device=dev)(u)):
                raise AssertionError(f"{code.name}: dual_diagonal != "
                                     "generator")
        print(f"[4 encode] dual_diagonal == generator on {len(cells)} "
              f"registry cells at b={BATCH}")
        cfg = DecodeCfg()
        for si, ((family, rate), (ebn0, frames, ref)) in enumerate(
                NR_ROWS.items()):
            code = CodeSpec(family=family, rate=rate, Z=64).build()
            _run_ber_check(run_ber, code, cfg, "punctured minsum flooding 50",
                           7 + si, frames=frames, ref=ref, ebn0=ebn0,
                           adapt=ChannelCfg().build_adapt(code))
        code = CodeSpec(family="nr2", rate="1/5", Z=64).build()
        for arm, (fer, undetected) in CRC_ARMS.items():
            ref = _wilson_interval(round(fer * CRC_FRAMES), CRC_FRAMES)
            res = _run_ber_check(
                run_ber, code, cfg, f"punctured {arm} arm", CRC_SEED,
                frames=CRC_FRAMES, ref=ref, ebn0=CRC_EBN0,
                adapt=ChannelCfg().build_adapt(code),
                crc=None if arm == "syndrome" else arm)
            print(f"[4 crc] {arm} arm: undetected {res.undetected} "
                  f"(frozen {undetected}), detected {res.detected}")
            if arm == "crc24" and res.undetected > 1:
                raise AssertionError(f"crc24 arm: {res.undetected} "
                                     "undetected > 1")
            if arm == "syndrome" and res.undetected < 1:
                raise AssertionError("syndrome arm: no undetected error, "
                                     "the control shows nothing")
        for bg, ebn0, frozen in HARQ_LADDERS:
            kw = dict(Z=64, stage_m=tuple(frozen), ebn0_db=ebn0, batch=BATCH,
                      seed=0, crc="crc24", bg=bg, device="cuda")
            t0 = time.perf_counter()
            res = run_irharq(**kw)
            wall = time.perf_counter() - t0
            ref = run_irharq(impl="torch", **kw)
            if dataclasses.asdict(res) != dataclasses.asdict(ref):
                raise AssertionError(f"bg{bg} HARQ: kernel != plain "
                                     f"({res} against {ref})")
            for st in res.stages:
                want = round(frozen[st["m"]] * BATCH)
                got = round(st["fer_after"] * BATCH)
                lo, hi = _wilson_interval(got, BATCH)
                rlo, rhi = _wilson_interval(want, BATCH)
                print(f"[4 harq] bg{bg} {ebn0} dB m={st['m']}: "
                      f"undelivered {got} of {BATCH} (JAX run {want}, "
                      f"difference {got - want}), ok_frac "
                      f"{st['ok_frac']:.6f}")
                if not (lo <= rhi and rlo <= hi):
                    raise AssertionError(
                        f"bg{bg} m={st['m']}: [{lo:.4e}, {hi:.4e}] misses "
                        f"[{rlo:.4e}, {rhi:.4e}]")
            print(f"[4 harq] bg{bg} {ebn0} dB stages {tuple(frozen)}: kernel "
                  f"== plain on the card field for field; delivered "
                  f"{res.delivered}, false ACKs {res.false_acks}, "
                  f"avg bits sent {res.avg_bits_sent:.3f}, info rate "
                  f"{res.avg_info_rate:.6f}, wall {wall:.2f} s")
        csv = os.path.join(OUT_DIR, "nr1_r12_z64_crc24.csv")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_sim.main(["--family", "nr", "--z", "64", "--crc", "crc24",
                          "--ebn0", "1.6", "--device", "cuda", "--batch",
                          "4096", "--max-frames", "32768", "--csv", csv])
        print(out.getvalue(), end="")
        with open(csv) as f:
            row = f.read().strip().splitlines()[-1].split(",")
        if (int(row[1]) < 32768 or "rate adaptation: punctured=128 "
                not in out.getvalue()):
            raise AssertionError(f"CLI --family nr --crc: CSV row {row}")
        print(f"[4 cli] --family nr --crc crc24: wrote {csv}: "
              f"frames={row[1]} FER={row[7]}")

    for label, path, own in (("slice 1", slice1_path, KERNELS[:1]),
                             ("slice 2", slice2_path, KERNELS[1:4]),
                             ("slice 3", slice3_path, KERNELS[4:8]),
                             ("slice 4", slice4_path, KERNELS[8:]),
                             ("slice 7", slice7_path, KERNELS[:1]),
                             ("slice 8", lambda: _slice8_path(
                                 dev, kernel, cli_sim.main), KERNELS[:2]),
                             ("slice 9", lambda: _slice9_path(
                                 dev, chunk0, probe),
                              (KERNELS[0], KERNELS[2])),
                             ("slice 10", lambda: slice10.update(
                                 ranks=_slice10_path(dev)), KERNELS[:1]),
                             ("slice 11", lambda: slice11.update(
                                 _slice11_path(dev, smi)),
                              (KERNELS[0], KERNELS[1], KERNELS[4])),
                             ("slice 12", lambda: slice12.update(
                                 _slice12_path(dev, smi)), KERNELS[:2])):
        t_phase = time.perf_counter()
        reset_launches()
        path()
        torch.cuda.synchronize()
        counts = {kname: n for kname, n in LAUNCHES.items() if n}
        print(f"[4 main path] {label}: launches {counts}, wall "
              f"{time.perf_counter() - t_phase:.2f} s")
        for kname, *_ in own:
            if LAUNCHES[kname] < 1:
                raise AssertionError(f"{label} launched {kname} no time")
        for kname in launches:
            launches[kname] += LAUNCHES[kname]

    # ---- 5. times (CUDA events, after warm-up) ----------------------------
    t_phase = time.perf_counter()
    info_bits = BATCH * judged.k
    results = []
    k_times = {}
    for kname, algo, sched, iters, source, replaces, mode in KERNELS:
        kind = _kind(algo, mode)
        run_off = kernel(kname, judged, iters, False)
        run_on = kernel(kname, judged, iters, True)
        plain_off = plain(kname, judged, iters, False)

        def kernel_off():
            run_off(llr)

        def kernel_on():
            return run_on(llr)

        def plain_run():
            plain_off(llr)

        for fn in (kernel_off, plain_run, kernel_on):
            fn()
        torch.cuda.synchronize()
        # plain, kernel, kernel, plain: both see the same card state
        p1 = _cuda_time_ms(plain_run, 2)
        k1 = _cuda_time_ms(kernel_off, 20)
        k2 = _cuda_time_ms(kernel_off, 20)
        p2 = _cuda_time_ms(plain_run, 2)
        k_on = _cuda_time_ms(kernel_on, 20)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        _, ok_on, iu_on = kernel_on()
        iters_on = float(iu_on.double().sum())
        bound_off, by_off = _bound_ms(judged, BATCH, kind, BATCH * iters)
        bound_on, by_on = _bound_ms(judged, BATCH, kind, iters_on)
        k_times[kname] = (k_ms, k_on)
        print(f"[5 time] {kname} {mode} judged b={BATCH} {iters} it "
              f"ET off: kernel "
              f"{k_ms:.4f} ms/batch ({k1:.4f}, {k2:.4f}) = "
              f"{k_ms / iters:.5f} ms/iteration = "
              f"{info_bits / k_ms * 1e3:.4e} info bit/s; plain {p_ms:.4f} "
              f"ms/batch ({p1:.4f}, {p2:.4f}); bound {bound_off:.5f} ms "
              f"({by_off})")
        print(f"[5 time] {kname} {mode} judged b={BATCH} 2.0 dB ET on "
              f"(mean iters "
              f"{iters_on / BATCH:.3f}): kernel {k_on:.4f} ms/batch = "
              f"{info_bits / k_on * 1e3:.4e} info bit/s; bound "
              f"{bound_on:.5f} ms ({by_on})")
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max_abs_err[kname], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_off, "bound_by": by_off,
            "library_ms": None,
        }
        if algo == "sumproduct":
            entry["frame_agreement"] = agreement[kname]
        results.append(entry)

    for new, old in (("minsum_quant_flood", "minsum_flood"),
                     ("minsum_quant_layered", "minsum_layered"),
                     ("spfast_flood", "sumproduct_flood"),
                     ("spfast_layered", "sumproduct_layered"),
                     ("spfast_flood", "minsum_flood"),
                     ("spfast_layered", "minsum_layered"),
                     ("minsum_compressed_flood", "minsum_flood"),
                     ("minsum_rescaled_flood", "minsum_flood"),
                     ("minsum_flood_bf16", "minsum_flood"),
                     ("minsum_layered_bf16", "minsum_layered"),
                     ("sumproduct_flood_bf16", "sumproduct_flood"),
                     ("sumproduct_layered_bf16", "sumproduct_layered"),
                     ("spfast_flood_bf16", "spfast_flood"),
                     ("spfast_layered_bf16", "spfast_layered"),
                     ("minsum_flood_normalized", "minsum_flood"),
                     ("minsum_layered_normalized", "minsum_layered")):
        (n_off, n_on), (o_off, o_on) = k_times[new], k_times[old]
        print(f"[5 time] {new} / {old}, same iterations: ET off "
              f"{n_off / o_off:.4f}x ({n_off:.4f} / {o_off:.4f} ms), ET on "
              f"{n_on / o_on:.4f}x ({n_on:.4f} / {o_on:.4f} ms)")

    # shift normalization on against off, ET off, in turns (off, on, on,
    # off, three times): decode() runs normalize=False because the
    # normalized kernels measured slower than the spread of these runs
    # (PERF.md, K9)
    for sched, iters in (("flooding", 50), ("layered", 25)):
        runs = {norm: build_cuda_decoder(judged, "minsum", iters,
                                         schedule=sched, early_stop=False,
                                         normalize=norm)
                for norm in (False, True)}
        ts = {False: [], True: []}
        for _ in range(3):
            for norm in (False, True, True, False):
                ts[norm].append(_cuda_time_ms(lambda: runs[norm](llr), 20))
        print(f"[5 K9] judged min-sum {sched} {iters} it ET off: normalized "
              f"{np.median(ts[True]):.4f} ms median {ts[True]}, unnormalized "
              f"{np.median(ts[False]):.4f} ms median {ts[False]}; ratio "
              f"{np.median(ts[True]) / np.median(ts[False]):.4f}")

    step1 = build_mc_step(judged, DecodeCfg(), BATCH, 1, device="cuda")
    step1(0, 0, 2.0, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(10):
        step1(0, 0, 2.0, t)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"[5 time] MC step judged b={BATCH} 2.0 dB (draw, encode, channel, "
          f"decode ET on, counters): {step_ms:.4f} ms host clock "
          f"= {info_bits / step_ms * 1e3:.4e} info bit/s")

    # slice 7: K1 and K2 on the punctured NR-like mothers, ET off at the
    # main-path iterations and ET on at the frozen rows' Eb/N0; the
    # dual-diagonal encoder against the generator path on the judged code
    for ci, (code, ebn0) in enumerate(nr_codes):
        nr_llr = _punctured_llrs(code, BATCH, ebn0, SEED + 40 + ci).to(dev)
        shifts = coordinates(code, False)[0]
        for kname in ("minsum_flood", "minsum_layered"):
            sched, iters = rows[kname][2], rows[kname][3]
            run_off = kernel(kname, code, iters, False)
            run_on = kernel(kname, code, iters, True)
            run_off(nr_llr)
            _, _, iu_on = run_on(nr_llr)
            torch.cuda.synchronize()
            t_off = [_cuda_time_ms(lambda: run_off(nr_llr), 20)
                     for _ in range(2)]
            t_on = _cuda_time_ms(lambda: run_on(nr_llr), 20)
            iters_on = float(iu_on.double().sum())
            bound_off, by_off = _bound_ms(code, BATCH, "minsum", BATCH * iters)
            bound_on, by_on = _bound_ms(code, BATCH, "minsum", iters_on)
            bucket = (layered_plan(code, shifts, 4, False).bucket
                      if sched == "layered"
                      else flood_plan(code, shifts).bucket)
            k_ms = sum(t_off) / 2
            # picoseconds per edge, iteration and frame, ET off
            pe, pe_judged = (ms * 1e9 / (iters * c.layout.E * c.Z * BATCH)
                             for ms, c in ((k_ms, code),
                                           (k_times[kname][0], judged)))
            print(f"[5 nr] {kname} {code.name} kMaxDeg={bucket} b={BATCH} "
                  f"{iters} it ET off: {k_ms:.4f} ms ({t_off[0]:.4f}, "
                  f"{t_off[1]:.4f}) = {k_ms / iters:.5f} ms/iteration, "
                  f"{pe:.4f} ps per edge-iteration (judged "
                  f"{pe_judged:.4f}: {pe / pe_judged:.4f}x); "
                  f"bound {bound_off:.5f} ms ({by_off}, "
                  f"{k_ms / bound_off:.1f}x)")
            print(f"[5 nr] {kname} {code.name} kMaxDeg={bucket} b={BATCH} "
                  f"punctured {ebn0} dB ET on (mean iters "
                  f"{iters_on / BATCH:.3f}): {t_on:.4f} ms; bound "
                  f"{bound_on:.5f} ms ({by_on}, {t_on / bound_on:.1f}x)")
    u = torch.randint(0, 2, (BATCH, judged.k), device=dev,
                      dtype=torch.uint8)
    encoders = {m: build_encoder(judged, m, device=dev)
                for m in ("generator", "dual_diagonal")}
    for fn in encoders.values():
        fn(u)
    torch.cuda.synchronize()
    ts = {m: [] for m in encoders}
    for m in ("generator", "dual_diagonal", "dual_diagonal", "generator"):
        ts[m].append(_cuda_time_ms(lambda: encoders[m](u), 20))
    print(f"[5 encode] judged b={BATCH}: generator (fp64 product) "
          f"{sum(ts['generator']) / 2:.4f} ms {ts['generator']}, "
          f"dual_diagonal (XOR of rolls) "
          f"{sum(ts['dual_diagonal']) / 2:.4f} ms {ts['dual_diagonal']}")

    # slice 11: the CLI's timer against this phase's CUDA events on K1
    a_ms, k1_ms = slice11["a"]["ms_per_batch"], k_times["minsum_flood"][0]
    print(f"[slice11] (a) {a_ms:.4f} ms/batch by the CLI's timer against "
          f"phase 5's K1 {k1_ms:.4f} ms/batch: ratio {a_ms / k1_ms:.4f} "
          f"(band {BENCH_K1_BAND}); {smi}")
    if abs(a_ms / k1_ms - 1) > BENCH_K1_BAND:
        raise AssertionError(f"(a) {a_ms} ms is not within "
                             f"{BENCH_K1_BAND:.0%} of K1's {k1_ms} ms")

    # slice 12: the tuner's judged ET-off times against this phase's
    for key, kname in (("layered_etoff_ms", "minsum_layered"),
                       ("flood_etoff_ms", "minsum_flood")):
        got, want = slice12["rows"]["qc1024_r12"][key], k_times[kname][0]
        print(f"[slice12] judged {key} {got:.4f} ms by the tuner against "
              f"phase 5's {kname} {want:.4f} ms: ratio {got / want:.4f} "
              f"(band {SLICE12_BAND}); {smi}")
        if abs(got / want - 1) > SLICE12_BAND:
            raise AssertionError(f"tuner {key} {got} ms is not within "
                                 f"{SLICE12_BAND:.0%} of {kname}'s {want}")

    _slice8_times(dev)
    _slice9_times(dev, probe, smi)
    _slice10_times(dev, slice10["ranks"], smi)
    results += _mc_batch_path(dev, smi)
    results.append(_gmem_path(dev, smi))

    print(f"[5] wall {time.perf_counter() - t_phase:.2f} s")

    if "jax" in sys.modules or "tpu_ldpc" in sys.modules:
        raise AssertionError("JAX or the JAX package was imported")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--slice10-rank"]:
        sys.exit(_slice10_rank(*sys.argv[2:]))
    sys.exit(main())
