"""The readings that set a cell's limits: each number the correctness
check compares, read for the program on some seeds and for the
lower-precision control on others, at the cell's own size and load.

    python benchmark/control.py --workload <cell> --seconds 2 \
        --program-seeds 1 2 3 ... --control-seeds 101 102 103

For every seed the cell runs as a benchmark run does (on the cards it
asks for): set-up, a short window of ``--seconds``, its answers kept.  A
program seed then reads ``check`` (the program against the reference); a
control seed reads ``control`` (bfloat16 message storage in the
program's place: the program's own bf16 kernel where its timed path can
select it, else the reference with its messages stored in bfloat16).
One JSON line a reading, then a summary: the largest program reading
and the smallest control reading of each number.  The benchmark's own
runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from ldpcbench.harness import BENCH_DIR, ROOT, run  # noqa: E402


def readings(root, bench_dir, workload, seconds, program_seeds,
             control_seeds, device_type, world=None):
    """{'program': {name: [values]}, 'control': {name: [values]}}, with a
    JSON line printed for each seed; world: ranks (the cell's chips
    unless given)."""
    out = {"program": {}, "control": {}}
    for side, seeds in (("program", program_seeds),
                        ("control", control_seeds)):
        judge = "check" if side == "program" else "control"
        for seed in seeds:
            result, checks, _ = run(root, bench_dir, workload, seed, seconds,
                                    False, device_type, 0.0, judge, world)
            got = {name: v for name, v, _ in checks}
            for name, v in got.items():
                out[side].setdefault(name, []).append(v)
            print(json.dumps({"workload": workload, "side": side,
                              "seed": seed, "attempted": result["attempted"],
                              "readings": got}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = readings(ROOT, BENCH_DIR, args.workload, args.seconds,
                   args.program_seeds, args.control_seeds, "cuda")
    print(json.dumps({
        "workload": args.workload,
        "card": torch.cuda.get_device_name(0),
        "program_largest": {n: max(v) for n, v in out["program"].items()},
        "control_smallest": {n: min(v) for n, v in out["control"].items()},
        "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
