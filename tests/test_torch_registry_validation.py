"""scripts/torch_registry_validation.py (the H100 twin of
scripts/registry_tpu_validation.py) on the CPU: its cells and chunk
streams are the TPU script's, and its protocol (stop rule, Wilson
interval, atomic one-row-a-cell CSV, resume) holds on a small code.  On
the CPU its "kernel" is the plain decoder, so only the protocol is
exercised here; K1 against the plain decoder runs on the card."""

import csv
import importlib.util
import os
import zlib

import numpy as np
import pytest

from tpu_ldpc.channel import noise_sigma2 as jax_noise_sigma2
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.codes.nrlike import nrlike_code as jax_nrlike_code
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.channel.awgn import noise_sigma2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return load("torch_registry_validation")


def test_cells_are_the_tpu_scripts(script):
    """Same cells, Eb/N0 and rate labels, pass by pass; the codes equal
    the JAX package's."""
    tpu = load("registry_tpu_validation")
    for ours, theirs in ((script.cells, tpu.cells),
                         (script.nr_operating_cells,
                          tpu.nr_operating_cells)):
        a, b = list(ours()), list(theirs())
        assert [(c, r, e) for c, _, r, e in a] == [
            (c, r, e) for c, _, r, e in b]
        for (_, build_a, *_), (_, build_b, *_) in zip(a[::20], b[::20]):
            code, ref = build_a(), build_b()
            assert code.name == ref.name
            np.testing.assert_array_equal(code.B, np.asarray(ref.B))
    assert len(list(script.cells())) == 43
    assert len(list(script.nr_operating_cells())) == 18


@pytest.mark.parametrize("cell,punctured", [
    ("judged", False), ("nr2_r15_z32", True)])
def test_chunk_llrs_are_the_tpu_scripts(script, cell, punctured):
    """Chunk 3 of a cell: the TPU script's u and LLRs, bit for bit
    (its golden encoder, its NumPy stream, its float64 arithmetic)."""
    if cell == "judged":
        ref = JaxLdpcCode.judged()
    else:
        ref = jax_nrlike_code("1/5", 32, bg=2)
    code = LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)
    n_punct = 2 * ref.Z if punctured else 0
    sigma2 = jax_noise_sigma2(1.2, ref.k / (ref.n - n_punct))
    assert noise_sigma2(1.2, code.k / (code.n - n_punct)) == sigma2
    u, llr = script.chunk_llrs(cell, 3, code, sigma2, n_punct, "cpu")
    # scripts/registry_tpu_validation.py's chunk
    rng = np.random.default_rng(zlib.crc32(f"{cell}/3".encode()))
    want_u = rng.integers(0, 2, (512, ref.k)).astype(np.uint8)
    x = 1.0 - 2.0 * golden_encode(ref.H, want_u).astype(np.float64)
    want = ((2.0 / sigma2) * (x + np.sqrt(sigma2)
            * rng.normal(size=x.shape))).astype(np.float32)
    want[:, :n_punct] = 0.0
    np.testing.assert_array_equal(u, want_u)
    np.testing.assert_array_equal(llr, want)


def test_protocol_on_a_small_code(script, tmp_path, monkeypatch):
    """The stop rule at an eighth of the frame counts (64-frame chunks,
    at least 512 frames)."""
    monkeypatch.setattr(script, "CHUNK", 64)
    monkeypatch.setattr(script, "MIN_FRAMES", 512)
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7), 8,
                                      "toy8")
    code = LdpcCode.from_base_graph(np.asarray(ref.B), 8, "toy8")
    out = str(tmp_path / "rows.csv")
    work = [("toy8_low", lambda: code, "1/2", 1.0),
            ("toy8_high", lambda: code, "1/2", 6.0)]
    lines = []
    fresh, n_fail, *_ = script.run_pass(work, out, False, "cpu",
                                        max_chunks=9, log=lines.append)
    assert n_fail == 0 and set(fresh) == {"toy8_low", "toy8_high"}
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [r["cell"] for r in rows] == ["toy8_low", "toy8_high"]
    low, high = rows
    assert list(low) == script.FIELDS and low["bitexact"] == "True"
    # 1.0 dB: 20 frame errors come in the first 512 frames, which the
    # stop rule takes in full; 6.0 dB: the cap of 9 chunks ends it
    assert int(low["frames"]) == 512 and float(low["fer"]) * 512 >= 20
    assert int(high["frames"]) == 9 * 64
    lo, hi = float(low["fer_lo"]), float(low["fer_hi"])
    assert lo < float(low["fer"]) < hi
    # a full-protocol rerun skips the row that meets the stop rule and
    # redoes the capped one
    lines.clear()
    fresh, *_ = script.run_pass(work[:1], out, False, "cpu",
                                log=lines.append)
    assert fresh == {} and "already validated" in lines[0]
    assert not os.path.exists(out + ".tmp")
