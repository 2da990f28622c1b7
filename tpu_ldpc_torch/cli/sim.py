"""`python -m tpu_ldpc_torch.cli.sim` -- BER/FER sweep CLI (port of
``tpu_ldpc/cli/sim.py``).  Usage:

    python -m tpu_ldpc_torch.cli.sim --family judged --ebn0 1.0 2.0 3.0 \
        --device cuda --target-fe 100 --csv out.csv --checkpoint sweep.json
    python -m tpu_ldpc_torch.cli.sim --family judged --ebn0 2.0 \
        --schedule layered --iters 25
    python -m tpu_ldpc_torch.cli.sim --family judged --ebn0 2.0 \
        --quant-bits 6 --quant-step 0.25
    python -m tpu_ldpc_torch.cli.sim --family judged \
        --algo sumproduct-fast --find-fer 1e-2 --ebn0 1.5 2.5
    python -m tpu_ldpc_torch.cli.sim --family nr --rate 1/2 --z 64 \
        --crc crc24 --ebn0 1.6
    python -m tpu_ldpc_torch.cli.sim --family sc --sc-length 32 --z 64 \
        --schedule windowed --window 8 --window-sweep layered --iters 4 \
        --ebn0 3.0
    python -m tpu_ldpc_torch.cli.sim --family judged --algo wbf --ebn0 4.0

``--device`` defaults to cuda and raises without a card; ``--device cpu``
runs the plain PyTorch path.  ``--algo`` minsum | sumproduct |
sumproduct-fast | bitflip | wbf (the last two hard-decision),
``--schedule`` flooding | layered | windowed (SC chains: ``--window``
block-rows, ``--iters`` per slide, ``--window-sweep`` flooding |
layered), ``--impl`` auto | torch | cuda, fixed-point min-sum with
``--quant-bits`` / ``--quant-step`` / ``--quant-post-bits``.
``--find-fer FER`` bisects for the Eb/N0 at that FER between min and max
of ``--ebn0`` instead of sweeping.
``--family nr | nr2`` builds the NR-like codes (their two high-degree
systematic blocks punctured unless ``--puncture-blocks`` /
``--shorten-blocks`` name another adaptation); ``--crc`` attaches an
outer CRC that gates the detected / undetected counters.
``--mesh`` sweeps over the ranks of the process group
(``dist/mesh.py``: one process per rank, launched by ``torchrun``, see
``cli/launch.py``; alone it makes a group of one): `--batch` frames a
rank, counters all-reduced, and only rank 0 prints the table and writes
the CSV / JSONL.  ``--profile DIR`` runs the sweep under
``torch.profiler`` (CPU, and CUDA activities on the card) and writes a
Chrome trace per rank, ``DIR/trace_rank<r>.json``, in which the port's
``ldpc.*`` spans (``spans.py``) bound each layer's host work.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time


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
    p.add_argument("--window-sweep", choices=["flooding", "layered"],
                   help="schedule inside the window for --schedule "
                        "windowed")
    p.add_argument("--window", type=int,
                   help="window width in block-rows (schedule=windowed)")
    p.add_argument("--quant-bits", type=int,
                   help="fixed-point emulation: message width in bits "
                        "(min-sum only; golden's quantization contract)")
    p.add_argument("--quant-step", type=float,
                   help="fixed-point emulation: LSB step, a power of two "
                        "(default 0.5)")
    p.add_argument("--quant-post-bits", type=int,
                   help="fixed-point emulation: APP width (default bits+2)")
    p.add_argument("--puncture-blocks", type=int, nargs="+", metavar="B",
                   help="block-columns to puncture (rate adaptation)")
    p.add_argument("--shorten-blocks", type=int, nargs="+", metavar="B",
                   help="info block-columns to shorten (rate adaptation)")
    p.add_argument("--crc", choices=["crc8", "crc16", "crc24", "crc32"],
                   help="attach an outer CRC to the info block and gate "
                        "the detected / undetected counters on it")
    p.add_argument("--impl", choices=["auto", "torch", "cuda", "jnp",
                                      "pallas"])
    p.add_argument("--device", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int)
    p.add_argument("--target-fe", type=int)
    p.add_argument("--max-frames", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--checkpoint", help="sweep state file (resume if exists)")
    p.add_argument("--csv", help="write waterfall CSV here")
    p.add_argument("--jsonl", help="write per-point JSONL records here")
    p.add_argument("--step-jsonl", help="write per-call JSONL records here")
    p.add_argument("--mesh", action="store_true",
                   help="shard the batch over the ranks of the process "
                        "group (all-reduced counters); see cli/launch.py")
    p.add_argument("--find-fer", type=float, metavar="FER",
                   help="instead of sweeping, bisect for the Eb/N0 at "
                        "this target FER (range = min/max of --ebn0)")
    p.add_argument("--profile", metavar="DIR",
                   help="trace the sweep with torch.profiler into "
                        "DIR/trace_rank<r>.json (Chrome trace)")
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
        "decode.window": args.window,
        "decode.window_sweep": args.window_sweep,
        "decode.quant_bits": args.quant_bits,
        "decode.quant_step": args.quant_step,
        "decode.quant_post_bits": args.quant_post_bits,
        "run.batch": args.batch, "run.target_frame_errors": args.target_fe,
        "run.max_frames": args.max_frames, "run.seed": args.seed,
        "run.state_path": args.checkpoint, "run.out_csv": args.csv,
        "run.jsonl": args.jsonl, "run.step_jsonl": args.step_jsonl,
        "run.device": args.device, "channel.crc": args.crc,
        "run.use_mesh": args.mesh or None,
    }
    for k, v in direct.items():
        if v is not None:
            overrides.append(f"{k}={json.dumps(v)}")
    if args.ebn0:
        overrides.append(f"channel.ebn0_grid={json.dumps(args.ebn0)}")
    for key in ("puncture_blocks", "shorten_blocks"):
        blocks = getattr(args, key)
        if blocks is not None:
            overrides.append(f"channel.{key}={json.dumps(blocks)}")
    return SimConfig.from_sources(args.config, overrides)


@contextlib.contextmanager
def _profiled(trace_dir: str | None, device: str, rank: int):
    """torch.profiler around the block, its Chrome trace written to
    trace_dir/trace_rank<rank>.json (nothing when trace_dir is None)."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"trace_rank{rank}.json"))


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)

    from tpu_ldpc_torch.report.waterfall import waterfall_csv, waterfall_table
    from tpu_ldpc_torch.sim.mc import run_ber
    from tpu_ldpc_torch.sim.state import SweepState

    code = cfg.code.build()
    adapt = cfg.channel.build_adapt(code)
    chash = cfg.config_hash()
    state = (
        SweepState(cfg.run.state_path, chash) if cfg.run.state_path else None
    )
    mesh = None
    if cfg.run.use_mesh:
        import torch
        import torch.distributed as dist

        from tpu_ldpc_torch.dist.mesh import init_distributed, make_mesh

        init_distributed(device=cfg.run.device)
        mesh = make_mesh()
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[launch] process {mesh.rank}/{mesh.size}: backend "
              f"{dist.get_backend()}, device {mesh.device}, {cards} local "
              "card(s)", flush=True)
    rank0 = mesh is None or mesh.rank == 0  # the one rank that reports
    profiled = _profiled(args.profile, cfg.run.device,
                         0 if mesh is None else mesh.rank)

    if args.find_fer is not None:
        from tpu_ldpc_torch.sim.search import find_ebn0_at_fer

        grid = cfg.channel.ebn0_grid
        t0 = time.time()
        with profiled:
            sr = find_ebn0_at_fer(
                code, args.find_fer, cfg=cfg.decode,
                lo=min(grid), hi=max(grid),
                target_frame_errors=cfg.run.target_frame_errors,
                batch=cfg.run.batch, seed=cfg.run.seed, mesh=mesh,
                adapt=adapt, progress=rank0, device=cfg.run.device,
            )
        status = "converged" if sr.converged else "OUT OF RANGE"
        if rank0:
            print(f"\nEb/N0 @ FER {args.find_fer:.2e}: {sr.ebn0_db:.3f} dB "
                  f"(bracket [{sr.bracket[0]:.3f}, {sr.bracket[1]:.3f}], "
                  f"{status}, {len(sr.probes)} probes, "
                  f"wall={time.time() - t0:.1f}s)")
        return sr

    t0 = time.time()
    with profiled:
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
            adapt=adapt,
            crc=cfg.channel.crc,
            mesh=mesh,
            device=cfg.run.device,
        )
    wall = time.time() - t0
    if not rank0:
        return results

    if adapt is not None:
        k_eff, n_tx = adapt.dims(code.n, code.k)
        print(f"rate adaptation: punctured={len(adapt.puncture)} "
              f"shortened={len(adapt.shorten)} -> "
              f"(n_tx={n_tx}, k_eff={k_eff}, R_eff={k_eff / n_tx:.3f})")
    window = (f" window={cfg.decode.window} sweep={cfg.decode.window_sweep}"
              if cfg.decode.schedule == "windowed" else "")
    print(f"\ncode={code.name} (n={code.n}, k={code.k}, R={code.rate:.3f}) "
          f"algo={cfg.decode.algo} iters={cfg.decode.iters} "
          f"schedule={cfg.decode.schedule}{window} impl={cfg.decode.impl} "
          f"device={cfg.run.device} "
          f"{f'ranks={mesh.size} ' if mesh is not None else ''}"
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
