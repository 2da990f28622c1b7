"""`python -m tpu_ldpc_torch.cli.bench` -- decode throughput (port of
``tpu_ldpc/cli/bench.py``).

    python -m tpu_ldpc_torch.cli.bench --json
    python -m tpu_ldpc_torch.cli.bench --schedule layered --iters 25 --json
    python -m tpu_ldpc_torch.cli.bench --device cpu --batch 128 --iters 8

Times the decoder of ``build_bench_decoder`` (``decode/api.py``'s
``build_decode_fn``, which ``decode()`` and ``run_ber`` also use) with
the port's timer (``benchcore.py``: CUDA events around back-to-back
decodes of LLR buffers that together exceed the card's L2) and reports
ms per batch and decoded info bits/s.  The defaults are the judged
(1024, 512) code, flooding min-sum alpha 0.75, 50 iterations, early
termination off, 4096 codewords at 2.0 dB.

``--device`` defaults to cuda and raises without a card; ``--device
cpu`` runs the plain PyTorch decoder (host clock).  ``--json`` prints
one line: the JAX record's keys plus ``device_kind``, non-finite values
as null.  ``--profile DIR`` runs the timed loop under torch.profiler and
writes DIR/trace_rank0.json (``cli/sim.py::_profiled``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def build_bench_decoder(code, *, iters: int = 50, algo: str = "minsum",
                        alpha: float = 0.75, schedule: str = "flooding",
                        early_stop: bool = False, impl: str = "auto",
                        device):
    """The timed decoder: llr (batch, n) -> (bits, ok, iters_used).
    An impl the port does not have raises with a pointer to its
    counterpart (decode/api.py)."""
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    cfg = DecodeCfg(algo=algo, iters=iters, alpha=alpha, schedule=schedule,
                    impl=impl)
    return build_decode_fn(code, cfg, device, early_stop=early_stop)


def bench_decode(
    code,
    batch: int = 4096,
    iters: int = 50,
    algo: str = "minsum",
    alpha: float = 0.75,
    schedule: str = "flooding",
    early_stop: bool = False,
    ebn0_db: float = 2.0,
    reps: int = 30,
    impl: str = "auto",
    *,
    device="cuda",
    profile: str | None = None,
):
    """Time the decode path; returns (seconds/batch, info bits/s), NaN
    for both when the median is not a positive time."""
    from tpu_ldpc_torch.benchcore import make_timer
    from tpu_ldpc_torch.cli.sim import _profiled
    from tpu_ldpc_torch.codes_device import resolve_device

    device = resolve_device(device)
    fn = build_bench_decoder(
        code, iters=iters, algo=algo, alpha=alpha, schedule=schedule,
        early_stop=early_stop, impl=impl, device=device)
    timer = make_timer(code, batch, ebn0_db, device=device)
    with _profiled(profile, str(device), 0):
        dt = timer.measure(fn, reps=reps)["median_s"]
    if not (math.isfinite(dt) and dt > 0):
        print(f"warning: measured {dt * 1e3} ms/batch is not a positive "
              "time; the record gets null", file=sys.stderr)
        return float("nan"), float("nan")
    return dt, batch * code.k / dt


def main(argv=None):
    p = argparse.ArgumentParser(
        description="tpu-ldpc (PyTorch port) throughput benchmark")
    p.add_argument("--family", default="judged")
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=64)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--iters", type=int, default=50,
                   help="iteration budget")
    p.add_argument("--algo", default="minsum")
    p.add_argument("--schedule", default="flooding")
    p.add_argument("--early-stop", action="store_true")
    p.add_argument("--ebn0", type=float, default=2.0,
                   help="operating point, Eb/N0 in dB")
    p.add_argument("--reps", type=int, default=30,
                   help="back-to-back decodes a timed run")
    p.add_argument("--impl", default="auto",
                   choices=["auto", "torch", "cuda", "jnp", "pallas"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--profile", metavar="DIR",
                   help="trace the timed loop with torch.profiler into "
                        "DIR/trace_rank0.json")
    p.add_argument("--json", action="store_true", help="machine output")
    args = p.parse_args(argv)

    import torch

    from tpu_ldpc_torch.cli.config import CodeSpec
    from tpu_ldpc_torch.codes_device import resolve_device

    device = resolve_device(args.device)
    code = CodeSpec(family=args.family, rate=args.rate, Z=args.z).build()

    dt, thpt = bench_decode(
        code, batch=args.batch, iters=args.iters, algo=args.algo,
        schedule=args.schedule, early_stop=args.early_stop,
        ebn0_db=args.ebn0, reps=args.reps, impl=args.impl,
        device=device, profile=args.profile,
    )

    cuda = device.type == "cuda"
    rec = {
        "code": code.name, "n": code.n, "k": code.k, "ebn0_db": args.ebn0,
        "algo": args.algo, "iters": args.iters, "schedule": args.schedule,
        "early_stop": args.early_stop, "batch": args.batch,
        "backend": device.type,
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "ms_per_batch": dt * 1e3, "info_bits_per_s": thpt,
        "gbps": thpt / 1e9,
    }
    if args.json:
        # strict JSON: a NaN time would print as a bare NaN literal
        print(json.dumps({
            k: (None if isinstance(v, float) and not math.isfinite(v)
                else v)
            for k, v in rec.items()}))
    else:
        print(f"{code.name}: {args.algo} {args.iters} iters "
              f"({args.schedule}, early_stop={args.early_stop}) "
              f"batch={args.batch} on {rec['device_kind']}: "
              f"{dt * 1e3:.4f} ms/batch -> {thpt / 1e9:.4f} Gb/s info")
    return rec


if __name__ == "__main__":
    main()
