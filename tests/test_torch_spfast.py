"""sumproduct-fast (lambda-min2 PWL sum-product) in the port (the CPU path
and the oracle of the K4 kernels) vs the JAX package, mirroring
tests/test_spfast.py.

Every op of the contract is an exact or correctly rounded fp32 op
(golden/decoder.py, the block above _ctilde), so the port's plain decoder
must agree bit for bit on bits, ok and iters_used with the golden float32
model, the jnp reference and the Pallas kernel in interpret mode, on both
schedules.  Rows of degree 1 and 2 take their own branches of the CN
update; no registry code has them, so a hand-made base graph does.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc.golden.decoder import _ctilde as golden_ctilde
from tpu_ldpc.golden.decoder import _fpair as golden_fpair
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import LAUNCHES, build_cuda_decoder
from tpu_ldpc_torch.decode.reference import _ctilde, _fpair, build_decoder

torch.set_num_threads(1)

# rows of degree 1, 2, 3 and 4; every column is covered
LOWDEG_B = np.array([[0, -1, -1, -1, -1, -1],
                     [1, 2, -1, -1, -1, -1],
                     [-1, 3, 0, 5, -1, -1],
                     [2, -1, 1, -1, 4, 0]])


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def small_codes():
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=3), 8,
                                      "small8")
    return ref, twin(ref)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def port(code, llr, **kw):
    fn = build_decoder(code, "sumproduct-fast", **kw)
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


def golden(ref, llr, **kw):
    return golden_decode(ref.H, llr, algo="sumproduct-fast",
                         dtype=np.float32, **kw)


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


def test_ctilde_and_fpair_equal_golden():
    """The PWL pieces, bit for bit, over a grid that crosses every
    segment boundary, and the soft-min on magnitude pairs."""
    x = np.concatenate([np.linspace(0.0, 8.0, 4001),
                        [0.0, 0.5, 1.3, 2.28, 3.2, 5.545, 1e4]]).astype(
                            np.float32)
    np.testing.assert_array_equal(
        _ctilde(torch.from_numpy(x)).numpy().view(np.int32),
        golden_ctilde(x, np.float32).view(np.int32))
    rng = np.random.default_rng(4)
    a = np.abs(rng.normal(0, 3, 5000)).astype(np.float32)
    b = np.abs(rng.normal(0, 3, 5000)).astype(np.float32)
    a[:50] = b[:50]  # ties: |a - b| = 0
    a[50:60] = 0.0
    np.testing.assert_array_equal(
        _fpair(torch.from_numpy(a), torch.from_numpy(b)).numpy().view(
            np.int32),
        golden_fpair(a, b, np.float32).view(np.int32))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_bitexact_golden_jnp_pallas(schedule, early_stop):
    """tests/test_spfast.py::test_bitexact_golden_jnp_pallas on the port."""
    ref, code = small_codes()
    rng = np.random.default_rng(1)
    llr = rng.normal(0.5, 2.0, (32, code.n)).astype(np.float32) * 3
    kw = dict(iters=12, schedule=schedule, early_stop=early_stop)
    got = port(code, llr, **kw)
    assert_same(got, golden(ref, llr, **kw))
    assert_same(got, jnp_build_decoder(ref, "sumproduct-fast", **kw)(llr))
    assert_same(got, build_pallas_decoder(ref, "sumproduct-fast",
                                          batch_tile=128, interpret=True,
                                          **kw)(llr))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_noisy_codewords_bitexact(schedule):
    """Noisy codewords of the toy code, both converged and failed frames,
    against golden and the jnp reference."""
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7), 8,
                                      "toy8")
    code = twin(ref)
    llr = noisy_llrs(code, 40, 2.0, seed=5)
    kw = dict(iters=12, schedule=schedule)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(ref, llr, **kw))
    assert_same(got, jnp_build_decoder(ref, "sumproduct-fast", **kw)(llr))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_low_degree_rows(schedule, early_stop):
    """Rows of degree 1, 2 and 3 take their own branches; random LLRs
    need no encoder."""
    ref = JaxLdpcCode.from_base_graph(LOWDEG_B, 7, "lowdeg")
    code = twin(ref)
    assert sorted(np.bincount(code.layout.edge_row)) == [1, 2, 3, 4]
    rng = np.random.default_rng(3)
    llr = (rng.normal(0.8, 2.0, (48, code.n)) * 2).astype(np.float32)
    llr[0] = 4.0  # a codeword (all zeros) that converges at once
    kw = dict(iters=10, schedule=schedule, early_stop=early_stop)
    got = port(code, llr, **kw)
    assert_same(got, golden(ref, llr, **kw))
    assert_same(got, jnp_build_decoder(ref, "sumproduct-fast", **kw)(llr))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_judged_code(schedule):
    ref = JaxLdpcCode.judged()
    code = twin(ref)
    llr = noisy_llrs(code, 6, 1.25, seed=2)
    kw = dict(iters=30, schedule=schedule)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(ref, llr, **kw))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_signed_zero_llrs_follow_golden(schedule):
    """-0.0 is positive for the CN sign, the syndrome and the hard bit, as
    golden reads it (the Pallas kernel reads sign bits)."""
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7), 8,
                                      "toy8")
    code = twin(ref)
    llr = noisy_llrs(code, 16, 2.5, seed=12)
    pick = np.random.default_rng(13).random(llr.shape)
    llr[pick < 0.05] = 0.0
    llr[(pick >= 0.05) & (pick < 0.10)] = -0.0
    llr[(pick >= 0.10) & (pick < 0.12)] = 1e4
    llr[:4] = 5.0
    llr[:4, ::5] = -0.0
    for early_stop in (True, False):
        kw = dict(iters=12, schedule=schedule, early_stop=early_stop)
        got = port(code, llr, **kw)
        assert_same(got, golden(ref, llr, **kw))
        if early_stop:
            np.testing.assert_array_equal(got[2][:4], 0)


def test_decode_dispatch_and_quant_rejected():
    """decode(algo='sumproduct-fast') on the CPU == golden; quantization
    with sumproduct-fast raises, as in the JAX package."""
    ref, code = small_codes()
    llr = noisy_llrs(code, 16, 2.5, seed=9)
    want = golden(ref, llr, iters=20)
    got = decode(code, llr, algo="sumproduct-fast", iters=20, device="cpu")
    assert_same([x.numpy() for x in got], want)
    before = dict(LAUNCHES)
    got = build_cuda_decoder(code, "sumproduct-fast", 20)(
        torch.from_numpy(llr))
    assert_same([x.numpy() for x in got], want)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="minsum"):
        build_decoder(code, "sumproduct-fast", quant_bits=6)
    with pytest.raises(ValueError, match="minsum"):
        decode(code, llr, algo="sumproduct-fast", quant_bits=6,
               device="cpu")
