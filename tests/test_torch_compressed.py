"""Compressed row state in the port (the plain decoder's compressed=True:
the oracle of the K6 kernel) vs the JAX package.

Each check keeps (min1', min2', argmin slot, sign byte) in place of its
edges' messages and rebuilds them exactly, so the decode is bit-exact with
golden float32 and with the Pallas kernel (compressed=True, interpret
mode).  Signs read x < 0 as golden's do; the Pallas kernel reads sign bits
(q = -0.0 negative), so LLRs with exact zeros are held against golden
only (ROADMAP Queue 3).  Also here: the builder's refusals, held to the
JAX builder's exception types over the whole grid of mode arguments.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def toy_codes(Z=8):
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, Z, seed=7), Z,
                                      f"toy{Z}")
    return ref, twin(ref)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def assert_same(got, want, what=""):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what} {name}")


def port(code, llr, **kw):
    fn = build_decoder(code, "minsum", compressed=True, **kw)
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


@pytest.mark.parametrize("early_stop", [True, False])
def test_compressed_bitexact_vs_golden_and_pallas(early_stop):
    ref, code = toy_codes()
    llr = noisy_llrs(ref, 40, 3.0, seed=41)
    kw = dict(iters=12, alpha=0.75, early_stop=early_stop)
    got = port(code, llr, **kw)
    assert_same(got, golden_decode(ref.H, llr, algo="minsum",
                                   dtype=np.float32, **kw), "golden")
    pallas = build_pallas_decoder(ref, "minsum", compressed=True,
                                  interpret=True, **kw)
    assert_same(got, pallas(llr), "Pallas")
    assert 0 < got[1].mean() < 1


def test_compressed_offset_min_sum_and_judged_vs_golden():
    """Offset min-sum (beta > 0) on the toy code and the judged code at 30
    iterations, ET on and off; normalize is ignored, as in the JAX
    builder."""
    ref, code = toy_codes()
    llr = noisy_llrs(ref, 24, 2.5, seed=42)
    kw = dict(iters=10, alpha=1.0, beta=0.15)
    assert_same(port(code, llr, **kw),
                golden_decode(ref.H, llr, algo="minsum", dtype=np.float32,
                              **kw), "offset")
    ref, code = JaxLdpcCode.judged(), LdpcCode.judged()
    llr = noisy_llrs(ref, 6, 2.0, seed=43)
    for early_stop in (True, False):
        kw = dict(iters=30, alpha=0.75, early_stop=early_stop)
        want = golden_decode(ref.H, llr, algo="minsum", dtype=np.float32,
                             **kw)
        assert_same(port(code, llr, **kw), want, f"judged {early_stop}")
        assert_same(port(code, llr, normalize=True, **kw), want,
                    "normalize ignored")


def test_compressed_signed_zeros_vs_golden():
    """Exact +-0.0 and 1e4 LLRs: the x < 0 sign rule, held to golden."""
    ref, code = toy_codes()
    llr = noisy_llrs(ref, 24, 2.5, seed=44)
    pick = np.random.default_rng(44).random(llr.shape)
    llr[pick < 0.1] = 0.0
    llr[(pick >= 0.1) & (pick < 0.2)] = -0.0
    llr[(pick >= 0.2) & (pick < 0.25)] = 1e4
    llr[0, :] = 5.0
    llr[0, ::7] = -0.0
    for early_stop in (True, False):
        kw = dict(iters=10, alpha=0.75, early_stop=early_stop)
        got = port(code, llr, **kw)
        assert_same(got, golden_decode(ref.H, llr, algo="minsum",
                                       dtype=np.float32, **kw))
        assert_same(got, [x.numpy() for x in build_decoder(
            code, "minsum", **kw)(torch.from_numpy(llr))], "standard")
        if early_stop:
            assert got[2][0] == 0


@pytest.mark.parametrize("kw,code_of", [
    (dict(), "wifi"), (dict(schedule="layered"), "toy"),
    (dict(algo="sumproduct"), "toy"), (dict(algo="sumproduct-fast"), "toy"),
    (dict(quant_bits=6), "toy")],
    ids=["degree9", "layered", "sumproduct", "sumproduct-fast", "quant"])
def test_compressed_refusals(kw, code_of):
    """Row degree > 8 (wifi 2/3 Z=27: 9-10), layered, the sum-product CN
    updates and quantization: NotImplementedError, as the JAX builder."""
    ref = (JaxLdpcCode.from_family("wifi", "2/3", 27) if code_of == "wifi"
           else toy_codes()[0])
    for builder in (build_decoder, build_cuda_decoder):
        with pytest.raises(NotImplementedError):
            builder(twin(ref), compressed=True, **kw)
    with pytest.raises(NotImplementedError):
        build_pallas_decoder(ref, compressed=True, interpret=True, **kw)


def test_builder_refuses_what_pallas_refuses():
    """Over the grid of mode arguments, build_cuda_decoder raises where
    build_pallas_decoder raises, with the same exception type."""
    refs = [toy_codes()[0], JaxLdpcCode.from_family("wifi", "2/3", 27)]
    grid = itertools.product(
        refs, ("minsum", "sumproduct", "sumproduct-fast"),
        ("flooding", "layered"), (0.0, 0.1), (False, True), (False, True),
        (False, True), (None, 6), (10, 300))
    checked = 0
    for ref, algo, sched, beta, rescaled, bf16, compressed, qb, iters in grid:
        kw = dict(algo=algo, schedule=sched, beta=beta, rescaled=rescaled,
                  compressed=compressed, quant_bits=qb, iters=iters)
        try:
            build_pallas_decoder(ref, interpret=True, **kw,
                                 msg_dtype=jnp.bfloat16 if bf16 else None)
            want = None
        except (ValueError, NotImplementedError) as e:
            want = type(e)
        try:
            build_cuda_decoder(twin(ref), **kw,
                               msg_dtype=torch.bfloat16 if bf16 else None)
            got = None
        except (ValueError, NotImplementedError) as e:
            got = type(e)
        assert got is want, (ref.name, kw, bf16, got, want)
        checked += want is not None
    assert checked > 300
