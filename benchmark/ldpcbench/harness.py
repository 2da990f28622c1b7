"""One run of one benchmark cell, driven by data.

``BENCHMARK.json`` (at the checkout's root) names the cell; the cell
names a configuration (``configs/<name>.json``, its ``file``) and a
traffic mix (``traffic/<traffic>.json``); the traffic mix names its
driver (``drivers/<driver>.py``) and carries every parameter of the job.
Each per-layer metric of the cell is read by ``metrics/<name>.py``.  So a
configuration, a cell or a per-layer metric is added with files and
entries, and no file here changes.

A cell that asks for N > 1 cards runs on N ranks (``ranks.py``): this
process is rank 0 on cuda:0 and starts ranks 1 .. N-1, rank r on cuda:r,
all joined in one process group before set-up.  Every rank sets up and
measures; rank 0 alone traces, reads the trace, checks and prints.
``memory_peak_bytes`` is the largest rank's peak and ``count`` is N.

A driver is a module with four functions:

* ``setup(ctx) -> state``: builds the program's objects and the inputs
  from the seed, and warms up every shape the window uses;
* ``measure(ctx, state) -> dict``: the measured window, a closed loop
  inside the span ``trace.WINDOW``; returns ``attempted``, ``failed``,
  the cell's end-to-end values (``metrics``) and the program's counts
  that per-layer readers read (``readings``).  On several ranks every
  rank measures and the loop ends on a decision every rank holds;
* ``check(ctx, state) -> [(name, value, limit), ...]``: frees the
  program's state, runs the plain reference over the answers of the
  window (all, or a sample drawn from the seed) and returns each number
  compared with its limit (rank 0 only, once the group is left);
* ``control(ctx, state) -> [(name, value), ...]``: the same numbers with
  the lower-precision control in the program's place (``control.py``;
  the benchmark's own runs never call it).

``ctx.rank`` and ``ctx.world`` are 0 and 1 in a cell on one card.

A reader is a module with ``read(view) -> float | None``; ``view`` has
``trace`` (``trace.Trace`` or None), ``readings``, ``config`` and
``traffic``.  A reader that finds nothing to read returns None and the
metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import importlib.util
import json
import math
import os
import re
import sys
import time

import numpy as np

from ldpcbench import ranks, reference
from ldpcbench.trace import Tracer

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# the traced run's window: long enough for every per-layer count, short
# enough that reading the trace stays a small part of the run
TRACE_WINDOW_S = 4.0
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ldpc")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


@functools.lru_cache(maxsize=4)
def decode_kernel_names(csrc: str) -> tuple:
    """The decode kernels the program builds from its CUDA sources: the
    ``__global__`` functions of ``csrc/*.cu`` named ``bp_*_kernel``."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r"__global__", src):
            head = re.split(r"[{;]", src[m.end():], maxsplit=1)[0]
            head = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)",
                          " ", head)
            name = re.search(r"(\w+)\s*\(", head)
            if name and re.fullmatch(r"bp_\w+_kernel", name.group(1)):
                names.add(name.group(1))
    return tuple(sorted(names))


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: object
    tracer: Tracer
    rank: int = 0
    world: int = 1

    @functools.cached_property
    def ref_code(self) -> reference.Code:
        code = self.config["code"]
        return reference.Code(code["B"], code["Z"])

    def program_code(self):
        """The program's code object for the configuration's table."""
        from tpu_ldpc_torch.codes.code import LdpcCode

        code = self.config["code"]
        return LdpcCode.from_base_graph(np.asarray(code["B"]), code["Z"],
                                        code["name"])

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class View:
    trace: object
    readings: dict
    config: dict
    traffic: dict


def device_record(device, world: int = 1) -> dict:
    """The line's ``device`` (rank 0's card: cuda:0); on several ranks
    ``count`` is their number and ``memory_peak_bytes`` the largest
    rank's peak (a collective: every rank calls it)."""
    import torch

    if device.type != "cuda":
        peak, rec = 0, {"platform": "cpu", "kind": "cpu"}
    else:
        peak = int(torch.cuda.max_memory_allocated(device))
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}
    if world > 1:
        t = torch.tensor([peak], dtype=torch.int64, device=device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        peak = int(t.item())
    return dict(rec, count=int(world), memory_peak_bytes=peak)


def prepare(root: str, bench_dir: str, workload: str, seed: int,
            seconds: float, trace: bool, device, rank: int = 0,
            world: int = 1):
    """(bench, driver module, Context) of one run; rank 0 alone traces."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = _entry(bench["workloads"], workload, "workload")
    cfg_entry = _entry(bench["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{cell['traffic']}.json"))
    driver = load_module(os.path.join(bench_dir, "drivers",
                                      f"{traffic['driver']}.py"),
                         f"ldpcbench_driver_{traffic['driver']}")
    if trace:
        seconds = min(seconds, TRACE_WINDOW_S)
    ctx = Context(cell, config, traffic, int(seed), float(seconds), device,
                  Tracer(trace and rank == 0), rank, world)
    return bench, driver, ctx


def run_cell(root: str, bench_dir: str, workload: str, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             judge: str = "check", world: int = 1):
    """One run of one rank; on rank 0 returns (result dict, checks,
    timing of its phases), on the others None.  t_start: perf_counter()
    at process start, from which set-up is timed.  judge "control" puts
    the driver's lower-precision control in the check's place, each
    number against the check's limit.  world > 1: this process's rank of
    the group its environment names (``ranks.py``), on its own card."""
    import torch

    device, rank = torch.device(device), 0
    if world > 1:
        ranks.join(device.type)
        rank = torch.distributed.get_rank()
    if device.type == "cuda":
        device = torch.device("cuda", rank)
    bench, driver, ctx = prepare(root, bench_dir, workload, seed, seconds,
                                 trace, device, rank, world)
    e2e, layer = cell_metrics(bench, workload)
    state = driver.setup(ctx)
    ctx.sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    with ctx.tracer:
        out = driver.measure(ctx, state)
    t_read = time.perf_counter()
    dev = device_record(device, world)
    if world > 1:
        ranks.leave()
    if rank != 0:
        return None
    metrics = {}
    breakdown = None
    if trace:
        tr = ctx.tracer.trace()
        view = View(tr, out["readings"], ctx.config, ctx.traffic)
        for m in layer:
            reader = load_module(
                os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                "ldpcbench_metric_" + re.sub(r"\W", "_", m["name"]))
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        del tr, view
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"the {ctx.traffic['driver']} driver gives "
                               f"no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    ctx.tracer.prof = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if judge == "control":
        checks = [(name, v, driver.LIMITS[name])
                  for name, v in driver.control(ctx, state)]
    else:
        checks = driver.check(ctx, state)
    timing = {"setup_s": setup_s, "window_s": t_read - t_window,
              "trace_read_s": t_check - t_read,
              "check_s": time.perf_counter() - t_check}
    correct = (out["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks))
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, checks, timing


def run(root: str, bench_dir: str, workload: str, seed: int,
        seconds: float, trace: bool, device_type: str, t_start: float,
        judge: str = "check", world: int | None = None):
    """One run of a cell on `world` ranks (the cell's chips unless
    given): rank 0 here, the others started as processes of the harness
    (``ranks.Ranks``).  Returns rank 0's (result, checks, timing)."""
    if world is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        world = _entry(bench["workloads"], workload, "workload")["chips"]
    args = dict(root=root, bench_dir=bench_dir, workload=workload,
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=device_type, judge=judge, world=int(world))
    if world == 1:
        return run_cell(t_start=t_start, **args)
    with ranks.Ranks(world, "ldpcbench.harness:rank_main", args):
        return run_cell(t_start=t_start, **args)


def rank_main(**kwargs) -> int:
    """Ranks 1 .. N-1 of a run: the run, then the forbidden-modules
    check; the exit code."""
    run_cell(t_start=time.perf_counter(), **kwargs)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: rank {os.environ.get('RANK')} loaded {bad}",
              file=sys.stderr)
        return 3
    return 0


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load
    (the JAX package and JAX), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Run one cell of the tpu_ldpc_torch benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = _entry(bench["workloads"], args.workload, "workload")["chips"]
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks, timing = run(ROOT, BENCH_DIR, args.workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda",
                                 t_start, world=chips)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    timing["total_s"] = time.perf_counter() - t_start
    print("timing: " + ", ".join(f"{k} {v:.3f}" for k, v in timing.items()),
          file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
