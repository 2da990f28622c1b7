"""Shared helpers of the benchmark's CPU tests: the cells of
BENCHMARK.json, and a copy of the benchmark with each traffic mix cut by
its CPU cut (``traffic/cpu/<traffic>.json``) to a size the plain
decoders run on the CPU in a second or two."""

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for path in (HERE, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)

# ranks of a cell of several cards on the CPU (gloo)
CPU_RANKS = 2


def bench(root=REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cells(root=REPO) -> list:
    """The names of BENCHMARK.json's workloads."""
    return [c["name"] for c in bench(root)["workloads"]]


def chips(cell, root=REPO) -> int:
    return next(c["chips"] for c in bench(root)["workloads"]
                if c["name"] == cell)


def small_copy(dst: str, overrides=None) -> tuple:
    """(root, bench_dir) of a copy of BENCHMARK.json and benchmark/ under
    `dst`, each traffic mix cut by its CPU cut and then `overrides`
    ({traffic: {key: value}})."""
    bench_dir = os.path.join(dst, "benchmark")
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    cut_small(bench_dir, overrides)
    return dst, bench_dir


def cut_small(bench_dir: str, overrides=None) -> None:
    """Apply every CPU cut of `bench_dir` (and `overrides`) to its traffic
    mixes, in place."""
    cuts = os.path.join(bench_dir, "traffic", "cpu")
    for name in os.listdir(cuts):
        traffic = os.path.join(bench_dir, "traffic", name)
        with open(os.path.join(cuts, name)) as f:
            cut = json.load(f)
        with open(traffic) as f:
            data = json.load(f)
        data.update(cut)
        data.update((overrides or {}).get(name[:-len(".json")], {}))
        with open(traffic, "w") as f:
            json.dump(data, f)


def cpu_run(root, bench_dir, cell, seed, seconds, trace=False,
            judge="check"):
    """harness.run of `cell` on the CPU; a cell of several cards runs on
    CPU_RANKS gloo ranks."""
    from ldpcbench import harness

    world = min(chips(cell, root), CPU_RANKS)
    return harness.run(root, bench_dir, cell, seed, seconds, trace, "cpu",
                       0.0, judge, world)
