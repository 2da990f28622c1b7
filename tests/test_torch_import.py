"""The PyTorch port stands alone: tpu_ldpc_torch imports torch, never jax
and nothing of the JAX package tpu_ldpc (it keeps its own copies of the
framework-free modules it needs)."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = (
    "tpu_ldpc_torch", "tpu_ldpc_torch.codes", "tpu_ldpc_torch.codes.alist",
    "tpu_ldpc_torch.codes.gf2", "tpu_ldpc_torch.codes_device",
    "tpu_ldpc_torch.report.waterfall", "tpu_ldpc_torch.decode",
    "tpu_ldpc_torch.decode.cuda_bp", "tpu_ldpc_torch.decode.normalize",
    "tpu_ldpc_torch.decode.hard",
    "tpu_ldpc_torch.decode.windowed", "tpu_ldpc_torch.encode",
    "tpu_ldpc_torch.channel", "tpu_ldpc_torch.channel.adapt",
    "tpu_ldpc_torch.channel.bsc", "tpu_ldpc_torch.codes.crc",
    "tpu_ldpc_torch.codes.nrlike", "tpu_ldpc_torch.sim.harq",
    "tpu_ldpc_torch.encode.encoder", "tpu_ldpc_torch.sim",
    "tpu_ldpc_torch.sim.state", "tpu_ldpc_torch.sim.search",
    "tpu_ldpc_torch.cli.config",
    "tpu_ldpc_torch.cli.sim", "tpu_ldpc_torch.spans",
    "tpu_ldpc_torch._build", "tpu_ldpc_torch._native",
    "tpu_ldpc_torch.codes.anneal", "tpu_ldpc_torch.codes.peg",
    "tpu_ldpc_torch.codes.pexit", "tpu_ldpc_torch.codes.dmin",
    "tpu_ldpc_torch.codes.trapping", "tpu_ldpc_torch.cli.codegen",
    "tpu_ldpc_torch.report.plots", "tpu_ldpc_torch.dist",
    "tpu_ldpc_torch.dist.mesh", "tpu_ldpc_torch.dist.grid",
    "tpu_ldpc_torch.dist.partitioned", "tpu_ldpc_torch.dist.ring",
    "tpu_ldpc_torch.cli.launch", "tpu_ldpc_torch.cli.bench",
    "tpu_ldpc_torch.benchcore",
)


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_ldpc'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_module_imports_the_jax_package():
    """AST scan, module-level and function-level imports alike; the
    top-level name must be exactly tpu_ldpc (tpu_ldpc_torch shares its
    first letters)."""
    paths = sorted(glob.glob(os.path.join(REPO, "tpu_ldpc_torch", "**",
                                          "*.py"), recursive=True))
    paths += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "scripts", "torch_ab_time.py"),
              os.path.join(REPO, "scripts", "torch_registry_validation.py"),
              os.path.join(REPO, "scripts", "torch_tune_registry_knobs.py"),
              os.path.join(REPO, "scripts", "torch_roofline_audit.py"),
              os.path.join(REPO, "scripts", "torch_irharq.py"),
              os.path.join(REPO, "tests", "torch_dist_worker.py")]
    for mod in PORT_MODULES:  # every listed module is scanned
        rel = mod.replace(".", os.sep)
        assert (os.path.join(REPO, rel + ".py") in paths
                or os.path.join(REPO, rel, "__init__.py") in paths), mod
    assert len(paths) > 20
    for path in paths:
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in ("jax", "jaxlib", "tpu_ldpc")]
        assert not bad, (os.path.relpath(path, REPO), bad)


def test_chip_scripts_import_only_the_port():
    for path in ("chip_smoke.py", "tpu_ldpc_torch/cli/bench.py",
                 "scripts/torch_registry_validation.py",
                 "scripts/torch_tune_registry_knobs.py",
                 "scripts/torch_roofline_audit.py",
                 "scripts/torch_irharq.py"):
        mods = list(_imported_modules(os.path.join(REPO, path)))
        assert any(m.startswith("tpu_ldpc_torch") for m in mods), path
        bad = [m for m in mods
               if m.split(".")[0] in ("jax", "jaxlib", "tpu_ldpc")]
        assert not bad, (path, bad)


def test_chip_scripts_fail_without_a_card(tmp_path):
    """Without a card each card script exits 1 and writes no result; the
    registry tools' card scripts run only when given --device cpu."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    knobs, harq = tmp_path / "knobs.json", tmp_path / "harq.json"
    for argv in (["chip_smoke.py"],
                 ["-m", "tpu_ldpc_torch.cli.bench", "--json"],
                 ["scripts/torch_tune_registry_knobs.py", "--out",
                  str(knobs)],
                 ["scripts/torch_irharq.py", "--out", str(harq)]):
        out = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 1, (argv, out.stderr)
        assert '"ok"' not in out.stdout, argv
        assert "ms_per_batch" not in out.stdout, argv
    assert not knobs.exists() and not harq.exists()


def test_decode_numpy_input_asks_for_the_card(monkeypatch):
    """An entry point of the port runs on the card unless the caller asks
    for the CPU: NumPy LLRs with no device go to 'cuda' (which raises
    without a card), device='cpu' runs the plain version; a tensor stays
    on its own device."""
    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes import make_base_graph
    from tpu_ldpc_torch.decode import decode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = LdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7), 8,
                                    "toy8")
    llr = np.full((3, code.n), 4.0, np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        decode(code, llr)
    with pytest.raises(RuntimeError, match="is_available"):
        decode(code, torch.from_numpy(llr), device="cuda")
    bits, ok, iu = decode(code, llr, device="cpu")
    assert bits.device.type == "cpu" and ok.all() and (iu == 0).all()
    bits, ok, iu = decode(code, torch.from_numpy(llr))
    assert bits.device.type == "cpu" and ok.all()
