"""Plain layered decoding and exact sum-product (the CPU path and the
oracle of the K2 / K3 kernels) vs the JAX package.

Layered min-sum is bit-exact on bits, ok and iters_used against the
golden float32 model, the jnp reference and the Pallas kernel in
interpret mode.  Sum-product's tanh / log round differently in every
backend (golden even computes phi in float64), so it is held to the JAX
package's own frame-agreement contract: >= 97% of frames on the toy code
(tests/test_decode.py, tests/test_pallas.py), >= 95% on the judged code.
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
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import LAUNCHES, build_cuda_decoder
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


def port(code, llr, algo="minsum", **kw):
    fn = build_decoder(code, algo, **kw)
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


def golden(ref, llr, algo="minsum", dtype=np.float32, **kw):
    return golden_decode(ref.H, llr, algo=algo, dtype=dtype, **kw)


def jnp_ref(ref, llr, algo="minsum", **kw):
    return [np.asarray(x)
            for x in jnp_build_decoder(ref, algo, **kw)(llr)]


def pallas(ref, llr, algo="minsum", **kw):
    fn = build_pallas_decoder(ref, algo, batch_tile=128, interpret=True,
                              **kw)
    return [np.asarray(x) for x in fn(llr)]


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def agreement(got, want):
    """min(share of frames with equal bits, share with equal ok)."""
    return min((got[0] == want[0]).all(axis=1).mean(),
               (got[1] == want[1]).mean())


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("alpha,beta", [(0.75, 0.0), (1.0, 0.15)])
def test_layered_minsum_bitexact_toy(alpha, beta, early_stop):
    ref, code = toy_codes()
    llr = noisy_llrs(code, 40, 2.5, seed=5)
    kw = dict(iters=12, alpha=alpha, beta=beta, schedule="layered",
              early_stop=early_stop)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1  # both converged and failed frames
    assert_same(got, golden(ref, llr, **kw))
    assert_same(got, jnp_ref(ref, llr, **kw))
    assert_same(got, pallas(ref, llr, **kw))


@pytest.mark.parametrize("early_stop", [True, False])
def test_layered_minsum_bitexact_wifi27(early_stop):
    """Odd Z: the conditional wrap of the circulant index."""
    ref = JaxLdpcCode.from_family("wifi", "2/3", 27)
    code = twin(ref)
    llr = noisy_llrs(code, 8, 2.0, seed=6)
    kw = dict(iters=15, alpha=0.75, beta=0.0, schedule="layered",
              early_stop=early_stop)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(ref, llr, **kw))
    assert_same(got, jnp_ref(ref, llr, **kw))
    assert_same(got, pallas(ref, llr, **kw))


def test_layered_minsum_bitexact_judged():
    ref = JaxLdpcCode.judged()
    code = twin(ref)
    llr = noisy_llrs(code, 8, 1.25, seed=2)
    kw = dict(iters=25, alpha=0.75, beta=0.0, schedule="layered",
              early_stop=True)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(ref, llr, **kw))
    assert_same(got, jnp_ref(ref, llr, **kw))
    assert_same(got, pallas(ref, llr, **kw))


@pytest.mark.parametrize("early_stop", [True, False])
def test_layered_signed_zero_llrs_follow_golden(early_stop):
    """-0.0 is positive for the CN sign, the syndrome and the hard bit;
    before the first sweep the syndrome of the channel decision gives
    iters_used 0."""
    ref, code = toy_codes()
    llr = noisy_llrs(code, 16, 2.5, seed=12)
    rng = np.random.default_rng(13)
    pick = rng.random(llr.shape)
    llr[pick < 0.05] = 0.0
    llr[(pick >= 0.05) & (pick < 0.10)] = -0.0
    llr[(pick >= 0.10) & (pick < 0.12)] = 1e4
    llr[:4] = 5.0
    llr[:4, ::5] = -0.0
    kw = dict(iters=12, alpha=0.75, beta=0.0, schedule="layered",
              early_stop=early_stop)
    got = port(code, llr, **kw)
    assert_same(got, golden(ref, llr, **kw))
    if early_stop:
        np.testing.assert_array_equal(got[2][:4], 0)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_agrees_toy(schedule):
    """The JAX package's contract (tests/test_decode.py): >= 97% of frames
    agree on bits and on ok against golden (float64 phi) and jnp, and
    against the Pallas kernel in interpret mode (tests/test_pallas.py)."""
    ref, code = toy_codes(4)
    llr = noisy_llrs(code, 64, 4.0, seed=29)
    got = port(code, llr, "sumproduct", iters=30, schedule=schedule)
    gold = golden(ref, llr, "sumproduct", dtype=np.float64, iters=30,
                  schedule=schedule)
    assert agreement(got, gold) >= 0.97
    assert agreement(got, jnp_ref(ref, llr, "sumproduct", iters=30,
                                  schedule=schedule)) >= 0.97
    assert agreement(got, pallas(ref, llr, "sumproduct", iters=30,
                                 schedule=schedule)) >= 0.97


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_agrees_toy_waterfall(schedule):
    """At 2.0 dB, where frames fail: the same contract, and both outcomes
    occur."""
    ref, code = toy_codes()
    llr = noisy_llrs(code, 64, 2.0, seed=30)
    kw = dict(iters=20, schedule=schedule)
    got = port(code, llr, "sumproduct", **kw)
    assert 0 < got[1].mean() < 1
    gold = golden(ref, llr, "sumproduct", dtype=np.float64, **kw)
    assert agreement(got, gold) >= 0.97
    assert agreement(got, jnp_ref(ref, llr, "sumproduct", **kw)) >= 0.97


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_agrees_judged(schedule):
    """>= 95% on the judged code (tests/test_decode.py)."""
    ref = JaxLdpcCode.judged()
    code = twin(ref)
    llr = noisy_llrs(code, 24, 2.0, seed=31)
    got = port(code, llr, "sumproduct", iters=30, schedule=schedule)
    gold = golden(ref, llr, "sumproduct", dtype=np.float64, iters=30,
                  schedule=schedule)
    assert agreement(got, gold) >= 0.95
    assert agreement(got, jnp_ref(ref, llr, "sumproduct", iters=30,
                                  schedule=schedule)) >= 0.95


def extreme_llrs(n):
    return np.stack([
        np.full(n, 1e30, np.float32),
        np.full(n, -1e30, np.float32),
        np.zeros(n, np.float32),
        np.asarray([(1e20 if i % 2 else -1e20) for i in range(n)],
                   np.float32),
        np.asarray([0.0 if i % 3 else 1e-30 for i in range(n)], np.float32),
    ])


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_extreme_llrs_finite(schedule, early_stop):
    """phi's domain is clipped: huge magnitudes, exact zeros and 1e-30
    keep the posterior finite on both schedules (tests/test_decode.py
    test_sumproduct_no_nans_on_extreme_llrs)."""
    ref, code = toy_codes(4)
    llr = extreme_llrs(code.n)
    fn = build_decoder(code, "sumproduct", 8, schedule=schedule,
                       early_stop=early_stop)
    P, ok, iu = fn.posterior(torch.from_numpy(llr))
    assert torch.isfinite(P).all()
    bits, ok2, iu2 = fn(torch.from_numpy(llr))
    assert bits.shape == llr.shape and torch.equal(ok, ok2)
    assert torch.equal(iu, iu2) and ((iu >= 0) & (iu <= 8)).all()
    gb, gok, _ = golden(ref, llr, "sumproduct", dtype=np.float64, iters=8,
                        schedule=schedule, early_stop=early_stop)
    np.testing.assert_array_equal(ok.numpy(), gok)


def test_sumproduct_saturated_phi_is_negative_zero():
    """tanh(15) rounds to 1 in float32, so phi at the top clip is -0.0;
    the message is (sign product) * phi, as golden forms it, so a
    saturated row sends +-0.0 signed by the sign product alone."""
    from tpu_ldpc_torch.decode.reference import _cn_sumproduct, _phi

    x = torch.tensor([30.0, 1e30, 100.0])
    assert torch.equal(_phi(x), torch.zeros(3)) and (
        torch.signbit(_phi(x)).all())
    q = [torch.tensor([40.0]), torch.tensor([-50.0]), torch.tensor([60.0])]
    outs = _cn_sumproduct(q)
    # tot - phi_e is -0.0 - -0.0 = 0 -> clipped to 1e-9 -> phi large
    assert all(torch.isfinite(o).all() for o in outs)
    assert [bool(o < 0) for o in outs] == [True, False, True]


@pytest.mark.parametrize("algo,schedule,quantized", [
    pytest.param(*key, id="-".join(key[:2]) + ("-quant" if key[2] else ""))
    for key in sorted(
        [(algo, sched, False) for algo in ("minsum", "sumproduct",
                                           "sumproduct-fast")
         for sched in ("flooding", "layered")]
        + [("minsum", sched, True) for sched in ("flooding", "layered")])])
def test_wrappers_run_the_plain_version_on_cpu(algo, schedule, quantized):
    """Each kernel's decoder (build_cuda_decoder), given a CPU tensor,
    returns its plain version's result and launches nothing."""
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 12, 2.5, seed=14))
    quant = dict(quant_bits=5, quant_step=0.5) if quantized else {}
    before = dict(LAUNCHES)
    got = build_cuda_decoder(code, algo, 10, 0.75, 0.0, schedule,
                             **quant)(llr)
    want = build_decoder(code, algo, 10, 0.75, 0.0, schedule, **quant)(llr)
    assert_same([x.numpy() for x in got], [x.numpy() for x in want])
    assert LAUNCHES == before
    got = decode(code, llr, algo=algo, schedule=schedule, iters=10, **quant)
    assert_same([x.numpy() for x in got], [x.numpy() for x in want])
