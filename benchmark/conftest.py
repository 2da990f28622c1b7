"""Shared helpers of the benchmark's CPU tests: a copy of the benchmark
with its traffic cut to a size the plain decoders run on the CPU in a
second or two."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for path in (HERE, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)

# per traffic mix: the keys cut for the CPU; every other key as committed
SMALL = {
    "decode-minsum50-etoff-2.0dB": {"batch": 48, "buffers": 2,
                                    "check_calls": 3, "iters": 10},
    "mc-minsum50-b16384-2.0dB": {"batch": 48, "steps_per_call": 2,
                                 "check_calls": 2, "iters": 10},
    "mc-minsum50-b4096-1.6dB": {"batch": 24, "steps_per_call": 2,
                                "check_calls": 2, "iters": 10},
    "fersearch-spfast50-1e-2": {"batch": 48, "steps_per_call": 1,
                                "iters": 20, "target_fer": 0.1,
                                "lo_db": 0.5, "hi_db": 3.5, "tol_db": 0.5,
                                "target_frame_errors": 3, "max_frames": 96,
                                "check_probes": 2},
}
CELLS = ("judged-decode-etoff", "judged-mc-2.0dB", "nr1-mc-1.6dB",
         "judged-spfast-fersearch")


def small_copy(dst: str, overrides=None) -> tuple:
    """(root, bench_dir) of a copy of BENCHMARK.json and benchmark/ under
    `dst`, the traffic cut by SMALL and then `overrides` ({traffic:
    {key: value}})."""
    bench_dir = os.path.join(dst, "benchmark")
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    for name, over in SMALL.items():
        path = os.path.join(bench_dir, "traffic", f"{name}.json")
        with open(path) as f:
            traffic = json.load(f)
        traffic.update(over)
        traffic.update((overrides or {}).get(name, {}))
        with open(path, "w") as f:
            json.dump(traffic, f)
    return dst, bench_dir


@pytest.fixture
def small(tmp_path):
    return small_copy(str(tmp_path))
