"""CPU tests of the benchmark harness: its files are found by name and
parse, every cell of BENCHMARK.json prints the contract's line (a cell
of several cards on two gloo ranks), a rank that fails ends the run,
the roofline arithmetic, the reference against the program's plain
path, the import rules and adding a cell, a configuration, a traffic
mix and a metric as new files.

    python -m pytest benchmark/test_benchmark_harness.py -q
"""

import ast
import glob
import hashlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import (CPU_RANKS, HERE, REPO, bench, cells, chips,
                      cpu_run, cut_small, small_copy)

from ldpcbench import harness, reference, roofline
from ldpcbench.traffic import llr_buffers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")
CONFIGS = [c["name"] for c in bench()["configs"]]


def config_data(name, root=REPO):
    entry = next(c for c in bench(root)["configs"] if c["name"] == name)
    return harness.load_json(os.path.join(root, entry["file"]))


def check_structure(root):
    """Every structural check of the benchmark at `root` (BENCHMARK.json
    and its benchmark/): each file is found by name and parses, each
    cell has a CPU cut, and at most a quarter of the cells (or one) ask
    for four cards."""
    b = bench(root)
    bench_dir = os.path.join(root, "benchmark")
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for cfg in b["configs"]:
        assert NAME.match(cfg["name"])
        assert cfg["file"].startswith("benchmark/configs/")
        data = harness.load_json(os.path.join(root, cfg["file"]))
        B = np.asarray(data["code"]["B"])
        Z = data["code"]["Z"]
        assert B.shape[1] * Z == data["code"]["n"]
        assert (B.shape[1] - B.shape[0]) * Z == data["code"]["k"]
        assert int((B >= 0).sum()) == data["code"]["base_edges"]
        assert data["source"] == cfg["source"]
        assert set(data["program_code"]) == {"call", "args"}
    workloads = b["workloads"]
    assert len({c["name"] for c in workloads}) == len(workloads)
    assert len({(c["config"], c["traffic"]) for c in workloads}) == len(
        workloads)
    four = sum(c["chips"] == 4 for c in workloads)
    assert four <= max(1, len(workloads) // 4), "over 25% of cells on 4 cards"
    for cell in workloads:
        assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
        assert cell["config"] in {c["name"] for c in b["configs"]}
        traffic = harness.load_json(
            os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))
        cut = os.path.join("benchmark", "traffic", "cpu",
                           f"{cell['traffic']}.json")
        assert os.path.exists(os.path.join(root, cut)), (
            f"{cell['name']}: the traffic has no CPU cut; add {cut}")
        assert set(harness.load_json(os.path.join(root, cut))) <= set(traffic)
        driver = harness.load_module(
            os.path.join(bench_dir, "drivers", f"{traffic['driver']}.py"), "d")
        for fn in ("setup", "measure", "check", "control"):
            assert callable(getattr(driver, fn))
        e2e, layer = harness.cell_metrics(b, cell["name"])
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
        assert layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        reader = harness.load_module(
            os.path.join(bench_dir, "metrics", f"{m['name']}.py"), "r")
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_file_is_found_by_name_and_parses():
    check_structure(REPO)


def test_a_cell_without_a_cpu_cut_names_the_file_to_add(tmp_path):
    root, _ = small_copy(str(tmp_path))
    cell = bench(root)["workloads"][0]
    os.unlink(os.path.join(root, "benchmark", "traffic", "cpu",
                           f"{cell['traffic']}.json"))
    with pytest.raises(AssertionError, match=re.escape(
            f"add benchmark/traffic/cpu/{cell['traffic']}.json")):
        check_structure(root)


def program_code(spec):
    """The program's code from a configuration's ``program_code``: the
    call named by its dotted path, with its args."""
    parts = spec["call"].split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
            break
        except ModuleNotFoundError:
            continue
    for attr in parts[i:]:
        obj = getattr(obj, attr)
    return obj(*spec["args"])


@pytest.mark.parametrize("config", CONFIGS)
def test_config_tables_are_the_programs_codes(config):
    data = config_data(config)
    code = program_code(data["program_code"])
    assert data["code"]["name"] == code.name
    assert data["code"]["Z"] == code.Z
    assert np.array_equal(np.asarray(data["code"]["B"]), code.B)


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_gives_the_contracts_line(tmp_path, cell, trace):
    root, bench_dir = small_copy(str(tmp_path))
    result, checks, _ = cpu_run(root, bench_dir, cell, 2**31 + 11, 0.3,
                                trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + [
        "checks"]
    e2e, layer = harness.cell_metrics(bench(), cell)
    if trace:
        # no device on the CPU: the device's readers report nothing
        assert set(result["metrics"]) <= {m["name"] for m in layer}
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert result["device"]["count"] == min(chips(cell), CPU_RANKS)
    assert result["attempted"] > 0 and checks
    assert result["correct"], result["checks"]
    json.dumps(result)


def test_run_py_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _rank_run(root, bench_dir, cell, world):
    """A run of `cell` on `world` gloo ranks in a process of its own, as
    run.py runs a cell of several cards; (process, seconds)."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{HERE!r}, {REPO!r}]\n"
        "from ldpcbench import harness\n"
        f"out = harness.run({root!r}, {bench_dir!r}, {cell!r}, 7, 0.3, "
        f"False, 'cpu', 0.0, world={world})\n"
        "print(json.dumps(out[0]))\n")
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
    return p, time.monotonic() - t0


def _processes_naming(text):
    """The pids of the live processes whose command line holds `text`."""
    out = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                if text.encode() in f.read():
                    out.append(int(d))
        except (OSError, ValueError):
            continue
    return out


def test_a_rank_that_raises_ends_the_run(tmp_path):
    root, bench_dir = small_copy(str(tmp_path))
    cell = next(c for c in bench(root)["workloads"] if c["chips"] > 1)
    traffic = harness.load_json(
        os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))
    driver = os.path.join(bench_dir, "drivers", f"{traffic['driver']}.py")
    with open(driver, "a") as f:
        f.write("\n\n_setup = setup\n\n\ndef setup(ctx):\n"
                "    if ctx.rank == 1:\n"
                "        raise RuntimeError('rank 1 fails')\n"
                "    return _setup(ctx)\n")
    p, seconds = _rank_run(root, bench_dir, cell["name"], CPU_RANKS)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout
    assert "rank 1 fails" in p.stderr
    # rank 0 waits in its first collective: the run ends on the failure,
    # well before the group's timeout
    assert seconds < 120
    if os.path.isdir("/proc"):  # each rank's command line names the copy
        deadline = time.monotonic() + 10
        while _processes_naming(bench_dir) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not _processes_naming(bench_dir)


def test_roofline_arithmetic():
    # judged code, b=4096, 50 iterations, min-sum: 7 ops a edge-iteration
    least = roofline.least_seconds("minsum", 1024, 51, 64, 512, 4096,
                                   4096 * 50)
    assert round(least * 1e3, 5) == 0.06984
    assert roofline.decode_bytes(1024, 4096) / roofline.HBM_BYTES_PER_S \
        < least


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_reference_matches_the_programs_plain_decoder(config, algo,
                                                      early_stop, bf16):
    from tpu_ldpc_torch.decode.reference import build_decoder

    data = config_data(config)
    code = reference.Code(data["code"]["B"], data["code"]["Z"])
    ctx = harness.Context(None, data, None, 0, 0, CPU, None)
    gen = torch.Generator().manual_seed(7)
    llr = 2.5 * torch.randn((12, code.n), generator=gen) + 1.2
    for b in data["puncture_blocks"]:
        llr[:, b * code.Z:(b + 1) * code.Z] = 0.0
    llr[0] = torch.abs(llr[0])  # a frame that is a codeword at once
    want = build_decoder(ctx.program_code(), algo, 12, 0.75, 0.0,
                         "flooding", early_stop,
                         msg_dtype=torch.bfloat16 if bf16 else None)(llr)
    got = reference.Decoder(code, algo, 12, 0.75, early_stop,
                            msg_bf16=bf16)(llr)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_counters_match_the_programs_mc_step(config):
    from tpu_ldpc_torch.channel.adapt import RateAdapt
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    data = config_data(config)
    ctx = harness.Context(None, data, None, 0, 0, CPU, None)
    prog = ctx.program_code()
    blocks = tuple(data["puncture_blocks"])
    adapt = RateAdapt.from_blocks(prog, puncture_blocks=blocks) if blocks \
        else None
    step = build_mc_step(prog, DecodeCfg(iters=8), 16, 2, adapt, device=CPU)
    mc = reference.MonteCarlo(ctx.ref_code,
                              reference.Decoder(ctx.ref_code, "minsum", 8),
                              16, blocks, CPU)
    seed = 2**31 + 5
    for ebn0, ctr in ((0.5, 0), (1.5, 4)):
        got = np.asarray(step(seed, 0, ebn0, ctr).tolist())
        want = mc.call_counters(seed, 0, ctr, 2, ebn0)
        assert np.array_equal(got, want)
    assert step.k == ctx.ref_code.k


def test_reference_encoder_and_traffic():
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.encode.encoder import select_encoder

    prog = LdpcCode.judged()
    code = reference.Code(prog.B, prog.Z)
    u = torch.randint(0, 2, (9, code.k), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    enc, k, cols = select_encoder(prog, device=CPU)
    assert cols is None and k == code.k
    assert torch.equal(code.encode(u), enc(u))
    c = code.encode(u).numpy().astype(np.int64)
    assert not (code.H_dense().astype(np.int64) @ c.T % 2).any()
    a = llr_buffers(code, 8, 2.0, 2, 2**31 + 3, CPU)
    b = llr_buffers(code, 8, 2.0, 2, 2**31 + 3, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in harness.FORBIDDEN, (path, name)
    for mod in ("reference", "traffic", "roofline", "trace"):
        path = os.path.join(HERE, "ldpcbench", f"{mod}.py")
        assert all(n.split(".")[0] != "tpu_ldpc_torch"
                   for n in _imports(path)), path


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root, bench_dir = small_copy(str(tmp_path))
    cell = next(c["name"] for c in bench(root)["workloads"]
                if c["chips"] == 1 and harness.load_json(os.path.join(
                    bench_dir, "traffic", f"{c['traffic']}.json"))["driver"]
                == "mc")
    code = (
        "import sys\n"
        f"sys.path[:0] = [{HERE!r}, {REPO!r}]\n"
        "import torch\n"
        "from ldpcbench import harness\n"
        f"harness.run_cell({root!r}, {bench_dir!r}, {cell!r}, 3, "
        "0.2, True, torch.device('cpu'), 0.0)\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def _digests(bench_dir):
    out = {}
    for path in glob.glob(os.path.join(bench_dir, "**", "*"), recursive=True):
        if os.path.isfile(path) and "__pycache__" not in path:
            with open(path, "rb") as f:
                out[os.path.relpath(path, bench_dir)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_a_cell_config_and_metric_are_added_as_files(tmp_path):
    """A configuration, a traffic mix with its CPU cut, a one-card cell
    and a per-layer metric, added to a copy as new files and entries
    alone: every structural check passes on the copy, and the copy's own
    benchmark tests of the new cell and configuration pass there."""
    root = str(tmp_path)
    bench_dir = os.path.join(root, "benchmark")
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    before = _digests(bench_dir)
    b = bench(root)

    def write(rel, data):
        with open(os.path.join(root, rel), "w") as f:
            f.write(data if isinstance(data, str) else json.dumps(data))

    # a configuration: the first one's table under another name
    cfg = config_data(b["configs"][0]["name"], root)
    cfg["name"] = "copy-config"
    write("benchmark/configs/copy-config.json", cfg)
    b["configs"].append({"name": "copy-config", "source": cfg["source"],
                         "file": "benchmark/configs/copy-config.json",
                         "reduced": [], "why": "a test"})
    # a traffic mix with its CPU cut, from the first MC mix of one card
    mc = next(c for c in b["workloads"] if c["chips"] == 1
              and harness.load_json(os.path.join(
                  bench_dir, "traffic", f"{c['traffic']}.json"))["driver"]
              == "mc")
    for sub in ("", "cpu/"):
        data = harness.load_json(os.path.join(
            bench_dir, "traffic", f"{sub}{mc['traffic']}.json"))
        if not sub:
            data["ebn0_db"] = 1.0
        write(f"benchmark/traffic/{sub}copy-mc-1.0dB.json", data)
    # a cell, reporting the MC cell's end-to-end metric
    b["workloads"].append({"name": "copy-cell", "config": "copy-config",
                           "traffic": "copy-mc-1.0dB", "chips": 1,
                           "why": "a test"})
    e2e = next(m for m in b["end_to_end"]
               if mc["name"] in m.get("workloads", ()))
    e2e["workloads"].append("copy-cell")
    # a per-layer metric with a reader of its own
    write("benchmark/metrics/frames_seen.copy.py",
          "def read(view):\n    return view.readings['frames']\n")
    b["per_layer"].append({"name": "frames_seen.copy", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "MC step", "moves": e2e["name"],
                           "workloads": ["copy-cell"]})
    write("BENCHMARK.json", b)

    check_structure(root)
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before  # no file edited
    assert len(after) == len(before) + 4
    small_root = os.path.join(root, "small")
    shutil.copytree(root, small_root, ignore=shutil.ignore_patterns("small"))
    cut_small(os.path.join(small_root, "benchmark"))
    for trace in (True, False):
        result, _, _ = harness.run(small_root, os.path.join(
            small_root, "benchmark"), "copy-cell", 5, 0.3, trace, "cpu", 0.0)
        assert result["correct"], result["checks"]
        if trace:
            assert result["metrics"]["frames_seen.copy"]["value"] > 0
        else:
            assert set(result["metrics"]) == {e2e["name"], "setup_s"}
    # the copy's own tests, run on the copy, take the new cell and config
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k",
         "copy-cell or copy-config or parses or cpu_cut", bench_dir],
        capture_output=True, text=True, cwd=root, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stdout[-3000:]
    passed = re.search(r"(\d+) passed", p.stdout)
    assert passed and int(passed.group(1)) >= 10, p.stdout[-3000:]


def test_program_kernel_names():
    import tpu_ldpc_torch

    csrc = os.path.join(os.path.dirname(tpu_ldpc_torch.__file__), "csrc")
    names = harness.decode_kernel_names(csrc)
    assert "bp_flood_kernel" in names and "__launch_bounds__" not in names
    assert not [n for n in names if n.startswith("mc_")]
