"""The PyTorch port loads without JAX (tpu_ldpc_torch imports torch only)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import tpu_ldpc_torch, tpu_ldpc_torch.decode, tpu_ldpc_torch.sim\n"
        "import tpu_ldpc_torch.cli.sim, tpu_ldpc_torch.decode.cuda_bp\n"
        "import tpu_ldpc_torch.encode, tpu_ldpc_torch.channel\n"
        "import tpu_ldpc_torch.sim.state, tpu_ldpc_torch.cli.config\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_chip_scripts_import_only_the_port():
    for path in ("chip_smoke.py", "tpu_ldpc_torch/cli/profile_mc.py"):
        mods = list(_imported_modules(os.path.join(REPO, path)))
        assert any(m.startswith("tpu_ldpc_torch") for m in mods), path
        bad = [m for m in mods
               if m.split(".")[0] in ("jax", "jaxlib", "tpu_ldpc")]
        assert not bad, (path, bad)


def test_chip_scripts_fail_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    for argv in (["chip_smoke.py"], ["-m", "tpu_ldpc_torch.cli.profile_mc"]):
        out = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 1, (argv, out.stderr)
        assert '"ok"' not in out.stdout, argv
