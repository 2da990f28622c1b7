"""Fixed-point quantized min-sum in the port (the CPU path and the oracle
of the K5 kernels) vs the JAX package, mirroring tests/test_quant.py.

The quantizer uses only exact fp32 ops (step a power of two), so the
port's plain decoder must agree bit for bit on bits, ok and iters_used
with the golden float32 model, the jnp reference and the Pallas kernel in
interpret mode, on both schedules.  The port decodes its own LdpcCode,
built from the JAX package's through LdpcCode.from_base_graph.
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
from tpu_ldpc.golden.decoder import quantize, saturate
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
from tpu_ldpc_torch.decode.reference import (
    build_decoder, make_quantizers, quant_params)

torch.set_num_threads(1)


def toy_codes(Z=8):
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, Z, seed=7), Z,
                                      f"toy{Z}")
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), Z, ref.name)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def port(code, llr, **kw):
    fn = build_decoder(code, "minsum", **kw)
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


EDGE_VALUES = np.array(
    [0.0, -0.0, 0.24, 0.25, 0.26, -0.26, 3.4, 100.0, -100.0, 1e-9, -0.1,
     -0.25, 0.75, -1.25, 1e4, -3e4], dtype=np.float32)


@pytest.mark.parametrize("bits,step,post", [(4, 0.5, 6), (6, 0.25, 8),
                                            (5, 1.0, 9), (8, 0.125, 10)])
def test_quantizers_equal_golden(bits, step, post):
    """quantize and both saturations equal golden's on the edge values of
    test_quantizer_properties, bit for bit (signs of zeros included)."""
    qz, sat_msg, sat_post = make_quantizers(bits, step, post)
    x = torch.from_numpy(EDGE_VALUES)
    want = quantize(EDGE_VALUES, bits=bits, step=step)
    got = qz(x).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    grid = want * 3  # grid values beyond both limits
    for sat, b in ((sat_msg, bits), (sat_post, post)):
        np.testing.assert_array_equal(
            sat(torch.from_numpy(grid)).numpy(),
            saturate(grid, bits=b, step=step))
    _, kmax, lim_msg, lim_post = quant_params(bits, step, post)
    assert kmax == (1 << (bits - 1)) - 1
    assert lim_msg == float(saturate(np.float32(1e9), bits, step))
    assert lim_post == float(saturate(np.float32(1e9), post, step))


def test_quantizer_properties():
    """tests/test_quant.py::test_quantizer_properties on the port."""
    qz, _, _ = make_quantizers(4, 0.5, 6)
    x = torch.tensor([0.0, 0.24, 0.25, 0.26, -0.26, 3.4, 100.0, -100.0,
                      1e-9])
    q = qz(x)
    assert q.tolist() == [0.0, 0.0, 0.5, 0.5, -0.5, 3.5, 3.5, -3.5, 0.0]
    neg = qz(torch.tensor([-0.1, -0.0]))
    assert not torch.signbit(neg).any()  # +0.0, never -0.0
    _, sat, _ = make_quantizers(4, 0.5, 6)
    assert sat(torch.tensor([10.0, -10.0, 1.25])).tolist() == [
        3.5, -3.5, 1.25]
    assert quant_params(4, 0.5) == quant_params(4, 0.5, 6)  # post: bits + 2


@pytest.mark.parametrize("step", [0.3, 0.75, 3.0, 0.0, -0.5])
def test_non_power_of_two_step_raises(step):
    _, code = toy_codes()
    with pytest.raises(ValueError, match="power of two"):
        make_quantizers(4, step, 6)
    with pytest.raises(ValueError, match="power of two"):
        build_decoder(code, "minsum", 5, quant_bits=4, quant_step=step)
    with pytest.raises(ValueError, match="power of two"):
        decode(code, np.zeros((2, code.n), np.float32), quant_bits=4,
               quant_step=step, device="cpu")


@pytest.mark.parametrize("schedule,qbits,qstep", [
    ("flooding", 4, 0.5), ("flooding", 6, 0.25),
    ("layered", 4, 0.5), ("layered", 6, 0.25)])
def test_quant_bitexact_golden_jnp_pallas(schedule, qbits, qstep):
    ref, code = toy_codes()
    llr = noisy_llrs(code, 40, 3.0, seed=11)
    kw = dict(iters=12, alpha=0.75, schedule=schedule, quant_bits=qbits,
              quant_step=qstep)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden_decode(ref.H, llr, algo="minsum",
                                   dtype=np.float32, **kw))
    assert_same(got, jnp_build_decoder(ref, "minsum", **kw)(llr))
    assert_same(got, build_pallas_decoder(ref, "minsum", batch_tile=128,
                                          interpret=True, **kw)(llr))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_quant_post_bits_and_et_vs_golden(schedule, early_stop):
    """An explicit APP width, ET on and off, +-0.0 and 1e4 LLRs."""
    ref, code = toy_codes()
    llr = noisy_llrs(code, 24, 2.5, seed=12)
    llr[1, ::3] = -0.0
    llr[2, ::5] = 1e4
    llr[3] = 5.0
    llr[3, ::7] = -0.0
    kw = dict(iters=12, alpha=0.75, schedule=schedule, early_stop=early_stop,
              quant_bits=5, quant_step=0.5, quant_post_bits=6)
    got = port(code, llr, **kw)
    assert_same(got, golden_decode(ref.H, llr, algo="minsum",
                                   dtype=np.float32, **kw))
    if early_stop:
        assert got[2][3] == 0


def test_quant_quality_vs_float():
    """tests/test_quant.py::test_quant_quality_vs_float on the port:
    6-bit near-transparent, 4-bit degraded but working, and the layered
    schedule must not collapse against flooding (its posterior update
    uses the unsaturated q; saturating it through the message range
    breaks the decoder)."""
    _, code = toy_codes()
    llr = noisy_llrs(code, 64, 3.5, seed=3)
    ok = {}
    for sched in ("flooding", "layered"):
        ok[sched, "float"] = int(port(code, llr, iters=20,
                                      schedule=sched)[1].sum())
        for qb, qs in ((4, 0.5), (6, 0.25)):
            ok[sched, qb] = int(port(code, llr, iters=20, schedule=sched,
                                     quant_bits=qb, quant_step=qs)[1].sum())
    for sched in ("flooding", "layered"):
        assert ok[sched, 6] >= ok[sched, "float"] - 2
        assert ok[sched, 4] >= int(0.7 * ok[sched, "float"])
        assert ok[sched, "float"] >= 48
    assert ok["layered", 4] >= ok["flooding", 4] - 6


def test_decode_quant_bits_equals_golden():
    """Dispatch plumbing: decode(quant_bits=5) == golden quantized."""
    ref, code = toy_codes()
    llr = noisy_llrs(code, 8, 4.0, seed=1)
    want = golden_decode(ref.H, llr, algo="minsum", iters=10,
                         dtype=np.float32, quant_bits=5, quant_step=0.5)
    got = decode(code, llr, iters=10, quant_bits=5, quant_step=0.5,
                 device="cpu")
    assert_same([x.numpy() for x in got], want)
    got = build_cuda_decoder(code, "minsum", 10, quant_bits=5)(
        torch.from_numpy(llr))
    assert_same([x.numpy() for x in got], want)


@pytest.mark.parametrize("kw", [
    dict(algo="sumproduct"), dict(algo="sumproduct-fast"),
    dict(algo="bitflip"), dict(algo="wbf"), dict(schedule="windowed")],
    ids=["sumproduct", "sumproduct-fast", "bitflip", "wbf", "windowed"])
def test_quant_with_other_algos_raises(kw):
    _, code = toy_codes()
    with pytest.raises(ValueError, match="quant"):
        decode(code, np.zeros((2, code.n), np.float32), quant_bits=6,
               device="cpu", **kw)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_quant_single_pass_et_equals_golden(schedule):
    """Quantized single-pass ET == golden quantized, and quantization
    visibly bends iters_used (else the equality proves nothing)."""
    ref, code = toy_codes()
    llr = noisy_llrs(code, 64, 2.0, seed=8)
    q = dict(quant_bits=5, quant_step=0.5)
    single = build_decoder(code, "minsum", 8, schedule=schedule, **q)(
        torch.from_numpy(llr))
    want = golden_decode(ref.H, llr, algo="minsum", iters=8,
                         schedule=schedule, dtype=np.float32, **q)
    assert_same([x.numpy() for x in single], want)
    float_iu = build_decoder(code, "minsum", 8, schedule=schedule)(
        torch.from_numpy(llr))[2]
    assert not torch.equal(float_iu, single[2])
