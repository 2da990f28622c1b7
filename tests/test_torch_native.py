"""The port's native host helper (tpu_ldpc_torch/_native, g++ at first
use) against its plain versions (the pure-Python counters of
codes/base_graphs.py, the NumPy codes/gf2.py) and the JAX package's
native helper, on the registry cells the construction tests use and on
scrambled base matrices; a failed build raises, and two processes can
build at once."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tpu_ldpc import _native as jax_native
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.golden import encoder as golden_enc
from tpu_ldpc_torch import _build, _native
from tpu_ldpc_torch.codes import base_graphs as bg
from tpu_ldpc_torch.codes import gf2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("judged", "1/2", 64), ("wifi", "3/4", 27), ("wimax", "5/6", 24)]


def jax_code(family, rate, Z):
    return (JaxLdpcCode.judged() if family == "judged"
            else JaxLdpcCode.from_family(family, rate, Z))


def scrambled(seed):
    """A 6x12 base matrix at Z=16 with random shifts (6- and 8-cycles)."""
    rng = np.random.default_rng(seed)
    B = bg.make_base_graph(6, 12, 16, seed=seed).copy()
    mask = B >= 0
    B[mask] = rng.integers(0, 16, mask.sum())
    return B, 16


@pytest.mark.parametrize("case", [f"{f}_{r}_{z}" for f, r, z in CELLS]
                         + ["scrambled0", "scrambled1", "scrambled2"])
def test_cycle_counters(case):
    if case.startswith("scrambled"):
        B, Z = scrambled(int(case[-1]))
    else:
        family, rate, Z = next(c for c in CELLS
                               if f"{c[0]}_{c[1]}_{c[2]}" == case)
        B = np.asarray(jax_code(family, rate, Z).B)
    for native, plain, ref in (
            (bg.count_4cycles, bg._count_4cycles_py, jax_native.count_4cycles),
            (bg.count_6cycles, bg._count_6cycles_py, jax_native.count_6cycles),
            (bg.ace6_cost, bg._ace6_cost_py, jax_native.ace6_cost),
            (bg.count_8cycles_raw, bg._count_8cycles_raw_py,
             jax_native.count_8cycles_raw),
            (bg.ace8_cost, bg._ace8_cost_py, jax_native.ace8_cost)):
        got = native(B, Z)
        assert got == ref(B, Z), native.__name__
        # the plain versions sum the same powers of two in the same order
        assert got == plain(B, Z), native.__name__
    assert bg.count_8cycles(B, Z) == bg.count_8cycles_raw(B, Z) // 8


@pytest.mark.parametrize("shape", [(3, 7), (12, 30), (20, 20), (8, 40),
                                   (70, 130)])
def test_gf2_rank_and_row_reduce(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    M = rng.integers(0, 2, shape).astype(np.uint8)
    M[-1] = M[0] ^ M[1 % shape[0]]  # rank-deficient
    rref, piv = _native.gf2_row_reduce(M)
    want_rref, want_piv = gf2.gf2_row_reduce(M)
    assert np.array_equal(rref, want_rref) and piv == want_piv
    assert np.array_equal(rref, golden_enc.gf2_row_reduce(M)[0])
    assert (_native.gf2_rank(M) == gf2.gf2_rank(M) == golden_enc.gf2_rank(M)
            == jax_native.gf2_rank(M))


@pytest.mark.parametrize("family,rate,Z", CELLS)
def test_gf2_inv_and_parity_map(family, rate, Z):
    ref = jax_code(family, rate, Z)
    Hd = np.asarray(ref.H.todense(), np.uint8)
    k = Hd.shape[1] - Hd.shape[0]
    parity = Hd[:, k:]
    assert np.array_equal(_native.gf2_inv(parity), gf2.gf2_inv(parity))
    want = golden_enc.parity_map(ref.H)
    assert np.array_equal(_native.parity_map(Hd), want)
    assert np.array_equal(gf2.parity_map(ref.H), want)
    assert np.array_equal(jax_native.parity_map(Hd), want)


def test_gf2_singular_raises():
    M = np.ones((4, 4), np.uint8)
    with pytest.raises(ValueError, match="singular"):
        _native.gf2_inv(M)
    with pytest.raises(ValueError, match="singular"):
        gf2.gf2_inv(M)
    with pytest.raises(ValueError, match="not invertible"):
        _native.parity_map(np.ones((4, 8), np.uint8))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: g++'s errors come back in the exception, and a
    missing compiler is named."""
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed.*undeclared_name"):
        _build.build_host_library(str(src), str(tmp_path / "out"))
    assert not [p for p in os.listdir(tmp_path / "out") if ".tmp" in p]
    src.write_text('extern "C" int f() { return 0; }\n')
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host_library(str(src), str(tmp_path / "out"))


def test_two_processes_build_at_once(tmp_path):
    """Two processes build the helper into an empty directory at the same
    time: each writes its own temporary file and renames it into place,
    so both load a whole library and nothing else is left behind."""
    src = tmp_path / "native.cpp"
    shutil.copy(_native._SRC, src)
    out = tmp_path / "build"
    code = (
        "import ctypes, sys\n"
        "import numpy as np\n"
        "from tpu_ldpc_torch._build import build_host_library\n"
        "path = build_host_library(sys.argv[1], sys.argv[2])\n"
        "lib = ctypes.CDLL(path)\n"
        "M = np.eye(5, dtype=np.uint8)\n"
        "lib.gf2_rank.restype = ctypes.c_int\n"
        "print(path, lib.gf2_rank(M.ctypes.data_as(ctypes.c_void_p), 5, 5))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src), str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr
    lines = {stdout.strip() for stdout, _ in outs}
    want = _build.host_library_path(str(src), str(out))
    assert lines == {f"{want} 5"}
    assert os.listdir(out) == [os.path.basename(want)]
