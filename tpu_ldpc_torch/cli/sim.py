"""`python -m tpu_ldpc_torch.cli.sim` -- BER/FER sweep CLI (port of
``tpu_ldpc/cli/sim.py``).  Usage:

    python -m tpu_ldpc_torch.cli.sim --family judged --ebn0 1.0 2.0 3.0 \
        --device cuda --target-fe 100 --csv out.csv --checkpoint sweep.json

``--device`` defaults to cuda and raises without a card; ``--device cpu``
runs the plain PyTorch path.  ``--mesh``, ``--profile`` and
``--find-fer`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import time

_NOT_PORTED_FLAGS = {
    "mesh": "multi-device sweeps are ROADMAP Queue 1 item 8",
    "profile": "profiling the sweep is not ported yet (ROADMAP Queue 1 item 9)",
    "find_fer": "the FER search (sim/search.py) is ROADMAP Queue 1 item 6",
}


def build_parser():
    p = argparse.ArgumentParser(
        description="tpu-ldpc (PyTorch port) Monte-Carlo BER/FER sweep")
    p.add_argument("--config", help="JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="dotted config override, e.g. decode.alpha=0.8")
    p.add_argument("--family", choices=["judged", "wifi", "wimax", "nr",
                                        "nr2", "sc", "alist"])
    p.add_argument("--sc-length", type=int, help="SC chain length L (family=sc)")
    p.add_argument("--rate")
    p.add_argument("--z", type=int)
    p.add_argument("--alist")
    p.add_argument("--ebn0", type=float, nargs="+")
    p.add_argument("--algo", choices=["minsum", "sumproduct",
                                      "sumproduct-fast", "bitflip", "wbf"])
    p.add_argument("--iters", type=int)
    p.add_argument("--alpha", type=float)
    p.add_argument("--beta", type=float)
    p.add_argument("--schedule", choices=["flooding", "layered", "windowed"])
    p.add_argument("--quant-bits", type=int,
                   help="fixed-point emulation (not ported yet)")
    p.add_argument("--impl", choices=["auto", "torch", "cuda", "jnp",
                                      "pallas", "twophase"])
    p.add_argument("--device", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int)
    p.add_argument("--target-fe", type=int)
    p.add_argument("--max-frames", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--checkpoint", help="sweep state file (resume if exists)")
    p.add_argument("--csv", help="write waterfall CSV here")
    p.add_argument("--jsonl", help="write per-point JSONL records here")
    p.add_argument("--step-jsonl", help="write per-call JSONL records here")
    p.add_argument("--mesh", action="store_true", help="not ported yet")
    p.add_argument("--find-fer", type=float, metavar="FER",
                   help="not ported yet")
    p.add_argument("--profile", metavar="DIR", help="not ported yet")
    return p


def args_to_config(args):
    from tpu_ldpc_torch.cli.config import SimConfig

    overrides = list(args.set)
    direct = {
        "code.family": args.family, "code.rate": args.rate, "code.Z": args.z,
        "code.path": args.alist, "code.L": args.sc_length,
        "decode.algo": args.algo, "decode.iters": args.iters,
        "decode.alpha": args.alpha, "decode.beta": args.beta,
        "decode.schedule": args.schedule, "decode.impl": args.impl,
        "decode.quant_bits": args.quant_bits,
        "run.batch": args.batch, "run.target_frame_errors": args.target_fe,
        "run.max_frames": args.max_frames, "run.seed": args.seed,
        "run.state_path": args.checkpoint, "run.out_csv": args.csv,
        "run.jsonl": args.jsonl, "run.step_jsonl": args.step_jsonl,
        "run.device": args.device,
    }
    for k, v in direct.items():
        if v is not None:
            overrides.append(f"{k}={json.dumps(v)}")
    if args.ebn0:
        overrides.append(f"channel.ebn0_grid={json.dumps(args.ebn0)}")
    return SimConfig.from_sources(args.config, overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, why in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(f"--{flag.replace('_', '-')}: {why}")
    cfg = args_to_config(args)

    from tpu_ldpc.report.waterfall import waterfall_csv, waterfall_table
    from tpu_ldpc_torch.sim.mc import run_ber
    from tpu_ldpc_torch.sim.state import SweepState

    code = cfg.code.build()
    chash = cfg.config_hash()
    state = (
        SweepState(cfg.run.state_path, chash) if cfg.run.state_path else None
    )
    t0 = time.time()
    results = run_ber(
        code,
        cfg.channel.ebn0_grid,
        cfg=cfg.decode,
        batch=cfg.run.batch,
        target_frame_errors=cfg.run.target_frame_errors,
        max_frames=cfg.run.max_frames,
        seed=cfg.run.seed,
        progress=True,
        state=state,
        step_log=cfg.run.step_jsonl or None,
        device=cfg.run.device,
    )
    wall = time.time() - t0

    print(f"\ncode={code.name} (n={code.n}, k={code.k}, R={code.rate:.3f}) "
          f"algo={cfg.decode.algo} iters={cfg.decode.iters} "
          f"schedule={cfg.decode.schedule} device={cfg.run.device} "
          f"config={chash} wall={wall:.1f}s\n")
    print(waterfall_table(results))
    if cfg.run.out_csv:
        with open(cfg.run.out_csv, "w") as f:
            f.write(f"# config_hash={chash}\n")
            f.write(waterfall_csv(results))
        print(f"wrote {cfg.run.out_csv}")
    if cfg.run.jsonl:
        with open(cfg.run.jsonl, "a") as f:
            for r in results:
                rec = {"config_hash": chash, "code": code.name,
                       "ebn0_db": r.ebn0_db, "frames": r.frames,
                       "bit_errors": r.bit_errors,
                       "frame_errors": r.frame_errors,
                       "detected": r.detected, "undetected": r.undetected,
                       "iter_sum": r.iter_sum, "fer": r.fer, "ber": r.ber,
                       "mean_iters": r.mean_iters, "wall_s": r.wall_s}
                f.write(json.dumps(rec) + "\n")
    return results


if __name__ == "__main__":
    main()
