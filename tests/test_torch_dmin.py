"""Minimum-distance tools in the port (codes/dmin.py, codes/gf2.py)
against the JAX package's, the same calls on both: nullspace bases and
ranks, exact d_min, the information-set and QC restricted-subcode bounds
with their certificates, and the decoder-impulse probe on the CPU."""

import numpy as np
import pytest

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import dmin as jax_dmin
from tpu_ldpc.codes import make_base_graph as jax_make_base_graph
from tpu_ldpc.golden.encoder import gf2_rank as golden_rank
from tpu_ldpc_torch.codes import LdpcCode, dmin
from tpu_ldpc_torch.codes.gf2 import gf2_rank

HAMMING_H = np.array([[1, 1, 0, 1, 1, 0, 0],
                      [1, 0, 1, 1, 0, 1, 0],
                      [0, 1, 1, 1, 0, 0, 1]], np.uint8)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_dmin.py's toy QC code (n=24, d_min 4) in both packages."""
    ref = JaxLdpcCode.from_base_graph(jax_make_base_graph(4, 6, 4, seed=5), 4)
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def matrices(tiny):
    return {"hamming": HAMMING_H,
            "hamming_dup_row": np.vstack([HAMMING_H, HAMMING_H[:1]]),
            "tiny_qc": np.asarray(tiny[0].H.todense(), np.uint8)}


@pytest.mark.parametrize("name", ["hamming", "hamming_dup_row", "tiny_qc"])
def test_nullspace_basis_and_rank(tiny, name):
    H = matrices(tiny)[name]
    B = dmin.gf2_nullspace_basis(H)
    assert np.array_equal(B, jax_dmin.gf2_nullspace_basis(H))
    assert gf2_rank(H) == golden_rank(H)
    assert B.shape[0] == H.shape[1] - gf2_rank(H)
    assert gf2_rank(B) == golden_rank(B) == B.shape[0]


def test_dmin_exact(tiny):
    assert dmin.dmin_exact(HAMMING_H) == jax_dmin.dmin_exact(HAMMING_H) == 3
    H = tiny[0].H.toarray()
    assert dmin.dmin_exact(H, max_dim=10) == 4
    with pytest.raises(ValueError, match="max_dim"):
        dmin.dmin_exact(H, max_dim=4)


@pytest.mark.parametrize("case", ["hamming", "tiny_qc", "judged",
                                  "hamming_target"])
def test_dmin_upper_bound_equals_jax(tiny, case):
    """Same bound, the same certificate codeword and the same stats for
    the same seed and restarts."""
    kw = dict(restarts=30, seed=1)
    if case == "judged":
        H, kw = JaxLdpcCode.judged().H, dict(restarts=4, seed=0)
    elif case == "hamming_target":
        H, kw = HAMMING_H, dict(restarts=1000, seed=0, target=3)
    else:
        H = matrices(tiny)[case]
    w, c, st = dmin.dmin_upper_bound(H, **kw)
    ww, wc, wst = jax_dmin.dmin_upper_bound(H, **kw)
    assert (w, st) == (ww, wst)
    assert np.array_equal(c, wc) and int(c.sum()) == w
    if case != "judged":
        assert w == {"hamming": 3, "hamming_target": 3, "tiny_qc": 4}[case]


def test_dmin_upper_bound_qc_equals_jax(tiny):
    got = dmin.dmin_upper_bound_qc(tiny[1], max_info_cols=2, restarts=20)
    want = jax_dmin.dmin_upper_bound_qc(tiny[0], max_info_cols=2,
                                        restarts=20)
    assert got[0] == want[0] == 4
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_certificate_check_raises():
    Hd = HAMMING_H
    with pytest.raises(RuntimeError, match="no certificate"):
        dmin._verify_certificate(Hd, None, 3)
    with pytest.raises(RuntimeError, match="not a codeword"):
        dmin._verify_certificate(Hd, np.eye(7, dtype=np.uint8)[0], 1)
    c = dmin.dmin_upper_bound(Hd, restarts=5)[1]
    with pytest.raises(RuntimeError, match="weight"):
        dmin._verify_certificate(Hd, c, int(c.sum()) + 1)


def test_impulse_probe_minsum_equals_jax(tiny):
    """Min-sum decodes bit for bit in both packages, so the whole stats
    dict matches; the bound is the exact d_min 4."""
    ub, st = dmin.estimate_dmin_impulse(tiny[1], algo="minsum",
                                        device="cpu")
    want_ub, want_st = jax_dmin.estimate_dmin_impulse(tiny[0], algo="minsum")
    assert (ub, st) == (want_ub, want_st)
    assert ub == 4 and st["converged_nonzero"] > 0


def test_impulse_probe_sumproduct(tiny):
    """Exact sum-product (the default) agrees frame by frame only on
    >= 0.97 of frames (its contract), so only the bound is compared."""
    ub, st = dmin.estimate_dmin_impulse(tiny[1], device="cpu")
    want_ub, want_st = jax_dmin.estimate_dmin_impulse(tiny[0])
    assert ub == want_ub == 4
    assert st["probes"] == want_st["probes"] == 4 * 24 + 2 * 512
    assert st["converged_nonzero"] > 0


def test_impulse_probe_decoder_override_and_device(tiny, monkeypatch):
    """A caller's decoder gets the probes as a tensor on the chosen
    device and may return NumPy; with no device the probe asks for the
    card, which raises without one."""
    import torch

    seen = []

    def decoder(llr):
        seen.append((llr.device.type, llr.dtype, tuple(llr.shape)))
        return (np.zeros(tuple(llr.shape), np.uint8),
                np.ones(llr.shape[0], bool), None)

    ub, st = dmin.estimate_dmin_impulse(tiny[1], pairs=4, decoder=decoder,
                                        device="cpu")
    assert seen == [("cpu", torch.float32, (4 * 24 + 2 * 4, 24))]
    assert ub is None and st["converged_nonzero"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dmin.estimate_dmin_impulse(tiny[1], pairs=4)
