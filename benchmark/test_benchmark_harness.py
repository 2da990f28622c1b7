"""CPU tests of the benchmark harness: its files are found by name and
parse, a run of each driver prints the contract's line, the roofline
arithmetic, the reference against the program's plain path, the import
rules and adding a cell, a configuration and a metric as new files.

    python -m pytest benchmark/test_benchmark_harness.py -q
"""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CELLS, HERE, REPO, small_copy

from ldpcbench import harness, reference, roofline
from ldpcbench.traffic import llr_buffers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")


def bench():
    return harness.load_json(os.path.join(REPO, "BENCHMARK.json"))


def test_every_file_is_found_by_name_and_parses():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert [c["name"] for c in b["workloads"]] == list(CELLS)
    for cfg in b["configs"]:
        assert NAME.match(cfg["name"])
        assert cfg["file"].startswith("benchmark/configs/")
        data = harness.load_json(os.path.join(REPO, cfg["file"]))
        B = np.asarray(data["code"]["B"])
        Z = data["code"]["Z"]
        assert B.shape[1] * Z == data["code"]["n"]
        assert (B.shape[1] - B.shape[0]) * Z == data["code"]["k"]
        assert int((B >= 0).sum()) == data["code"]["base_edges"]
        assert data["source"] == cfg["source"]
    for cell in b["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] == 1
        traffic = harness.load_json(
            os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
        driver = harness.load_module(
            os.path.join(HERE, "drivers", f"{traffic['driver']}.py"), "d")
        for fn in ("setup", "measure", "check", "control"):
            assert callable(getattr(driver, fn))
        e2e, layer = harness.cell_metrics(b, cell["name"])
        assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
        assert layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        reader = harness.load_module(
            os.path.join(HERE, "metrics", f"{m['name']}.py"), "r")
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_config_tables_are_the_programs_codes():
    from tpu_ldpc_torch.codes.code import LdpcCode
    from tpu_ldpc_torch.codes.nrlike import nrlike_code

    for name, code in (("judged-1024-r12", LdpcCode.judged()),
                       ("nrlike-bg1-r12-z64", nrlike_code("1/2", 64))):
        data = harness.load_json(
            os.path.join(HERE, "configs", f"{name}.json"))
        assert data["code"]["name"] == code.name
        assert data["code"]["Z"] == code.Z
        assert np.array_equal(np.asarray(data["code"]["B"]), code.B)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_gives_the_contracts_line(tmp_path, cell, trace):
    root, bench_dir = small_copy(str(tmp_path))
    result, checks, _ = harness.run_cell(root, bench_dir, cell, 2**31 + 11,
                                         0.3, trace, CPU, 0.0)
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
    assert result["attempted"] > 0 and checks
    assert result["correct"], result["checks"]
    json.dumps(result)


def test_run_py_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_roofline_arithmetic():
    # judged code, b=4096, 50 iterations, min-sum: 7 ops a edge-iteration
    least = roofline.least_seconds("minsum", 1024, 51, 64, 512, 4096,
                                   4096 * 50)
    assert round(least * 1e3, 5) == 0.06984
    assert roofline.decode_bytes(1024, 4096) / roofline.HBM_BYTES_PER_S \
        < least


@pytest.mark.parametrize("config", ["judged-1024-r12", "nrlike-bg1-r12-z64"])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_reference_matches_the_programs_plain_decoder(config, algo,
                                                      early_stop, bf16):
    from tpu_ldpc_torch.decode.reference import build_decoder

    data = harness.load_json(os.path.join(HERE, "configs", f"{config}.json"))
    code = reference.Code(data["code"]["B"], data["code"]["Z"])
    ctx = harness.Context(None, data, None, 0, 0, CPU, None)
    gen = torch.Generator().manual_seed(7)
    llr = 2.5 * torch.randn((12, code.n), generator=gen) + 1.2
    llr[:, :64 * len(data["puncture_blocks"])] = 0.0
    llr[0] = torch.abs(llr[0])  # a frame that is a codeword at once
    want = build_decoder(ctx.program_code(), algo, 12, 0.75, 0.0,
                         "flooding", early_stop,
                         msg_dtype=torch.bfloat16 if bf16 else None)(llr)
    got = reference.Decoder(code, algo, 12, 0.75, early_stop,
                            msg_bf16=bf16)(llr)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("config", ["judged-1024-r12", "nrlike-bg1-r12-z64"])
def test_reference_counters_match_the_programs_mc_step(config):
    from tpu_ldpc_torch.channel.adapt import RateAdapt
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    data = harness.load_json(os.path.join(HERE, "configs", f"{config}.json"))
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
    code = (
        "import sys\n"
        f"sys.path[:0] = [{HERE!r}, {REPO!r}]\n"
        "import torch\n"
        "from ldpcbench import harness\n"
        f"harness.run_cell({root!r}, {bench_dir!r}, 'judged-mc-2.0dB', 3, "
        "0.2, True, torch.device('cpu'), 0.0)\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_a_cell_config_and_metric_are_added_as_files(tmp_path):
    root, bench_dir = small_copy(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    # a configuration: the judged code's table under another name
    with open(os.path.join(bench_dir, "configs",
                           "judged-1024-r12.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "judged-copy"
    with open(os.path.join(bench_dir, "configs", "judged-copy.json"),
              "w") as f:
        json.dump(cfg, f)
    b["configs"].append({"name": "judged-copy", "source": cfg["source"],
                         "file": "benchmark/configs/judged-copy.json",
                         "reduced": [], "why": "a test"})
    # a traffic mix and a cell
    with open(os.path.join(bench_dir, "traffic",
                           "mc-minsum50-b16384-2.0dB.json")) as f:
        traffic = json.load(f)
    traffic["ebn0_db"] = 1.0
    with open(os.path.join(bench_dir, "traffic", "mc-test-1.0dB.json"),
              "w") as f:
        json.dump(traffic, f)
    b["workloads"].append({"name": "copy-mc-1.0dB", "config": "judged-copy",
                           "traffic": "mc-test-1.0dB", "chips": 1,
                           "why": "a test"})
    b["end_to_end"][1]["workloads"].append("copy-mc-1.0dB")
    # a per-layer metric with a reader of its own
    with open(os.path.join(bench_dir, "metrics", "frames_seen.mc.py"),
              "w") as f:
        f.write("def read(view):\n    return view.readings['frames']\n")
    b["per_layer"].append({"name": "frames_seen.mc", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "MC step", "moves": "mc_info_bits_per_s",
                           "workloads": ["copy-mc-1.0dB"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    result, _, _ = harness.run_cell(root, bench_dir, "copy-mc-1.0dB", 5,
                                    0.3, True, CPU, 0.0)
    assert result["correct"]
    assert result["metrics"]["frames_seen.mc"]["value"] > 0
    result, _, _ = harness.run_cell(root, bench_dir, "copy-mc-1.0dB", 5,
                                    0.3, False, CPU, 0.0)
    assert set(result["metrics"]) == {"mc_info_bits_per_s", "setup_s"}


def test_program_kernel_names():
    import tpu_ldpc_torch

    csrc = os.path.join(os.path.dirname(tpu_ldpc_torch.__file__), "csrc")
    names = harness.program_kernel_names(csrc)
    assert "bp_flood_kernel" in names and "__launch_bounds__" not in names
