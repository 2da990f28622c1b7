"""Port decoder vs the JAX package: bit-exact on bits, ok and iters_used.

The plain PyTorch flooding min-sum decoder (the CPU path of the port,
and the oracle of the CUDA kernel) is held against the golden float32
model and the jnp reference decoder on the same NumPy LLRs
(tests/test_torch_pallas.py holds it against the Pallas kernel in
interpret mode; tests/test_torch_layered_sp.py covers the layered
schedule and sum-product).  LLRs holding +-0.0 are compared with golden
only: the Pallas kernel reads sign bits where golden reads `x < 0`.
Every code is the port's own LdpcCode, built from the JAX package's
through LdpcCode.from_base_graph.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc.golden.hard import decode_hard
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
from tpu_ldpc_torch.codes_device import to_device
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)


def twin(ref):
    """The port's twin of a JAX package code (same B, Z and name)."""
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def toy_code(Z=8):
    return twin(JaxLdpcCode.from_base_graph(
        make_base_graph(4, 8, Z, seed=7), Z, f"toy{Z}"))


def jax_code(code):
    return JaxLdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)


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


def golden(code, llr, **kw):
    return golden_decode(code.H, llr, algo="minsum", dtype=np.float32, **kw)


def jnp_ref(code, llr, **kw):
    return [np.asarray(x)
            for x in jnp_build_decoder(jax_code(code), "minsum", **kw)(llr)]


def assert_same(got, want):
    names = ("bits", "ok", "iters_used")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", ["toy", "wifi_z27", "judged"])
def test_to_device_carries_the_layout(name):
    code = {"toy": toy_code,
            "wifi_z27": lambda: twin(JaxLdpcCode.from_family("wifi", "2/3", 27)),
            "judged": lambda: twin(JaxLdpcCode.judged())}[name]()
    lay = code.layout
    dc = to_device(code, "cpu")
    assert dc is to_device(code, torch.device("cpu"))  # cached per pair
    assert dc.E == lay.E
    for field in ("edge_row", "edge_col", "edge_shift", "row_ptr",
                  "col_slots", "col_mask", "col_deg"):
        np.testing.assert_array_equal(getattr(dc, field).numpy(),
                                      getattr(lay, field), err_msg=field)
    # the valid column slots are a prefix of length col_deg
    np.testing.assert_array_equal(lay.col_mask.sum(axis=1), lay.col_deg)
    assert lay.col_mask[np.arange(lay.nb), lay.col_deg - 1].all()
    np.testing.assert_array_equal(dc.parity_MT.numpy(), code.parity_M.T)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("alpha,beta", [(0.75, 0.0), (1.0, 0.15)])
def test_plain_bitexact_vs_golden_jnp(alpha, beta, early_stop):
    code = toy_code()
    llr = noisy_llrs(code, 40, 2.5, seed=5)
    kw = dict(iters=12, alpha=alpha, beta=beta, early_stop=early_stop)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1  # both converged and failed frames
    assert_same(got, golden(code, llr, **kw))
    assert_same(got, jnp_ref(code, llr, **kw))


def test_odd_z_wifi27():
    code = twin(JaxLdpcCode.from_family("wifi", "2/3", 27))
    llr = noisy_llrs(code, 8, 2.0, seed=6)
    kw = dict(iters=20, alpha=0.75, beta=0.0, early_stop=True)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(code, llr, **kw))
    assert_same(got, jnp_ref(code, llr, **kw))


def test_judged_code():
    code = twin(JaxLdpcCode.judged())
    llr = noisy_llrs(code, 8, 1.25, seed=2)
    kw = dict(iters=50, alpha=0.75, beta=0.0, early_stop=True)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(code, llr, **kw))
    assert_same(got, jnp_ref(code, llr, **kw))


@pytest.mark.parametrize("batch", [1, 7])
def test_small_batches(batch):
    """Batch 1 and a ragged 7: the same rows as in a batch of 40."""
    code = toy_code()
    llr = noisy_llrs(code, 40, 2.5, seed=9)
    kw = dict(iters=10, alpha=0.75, beta=0.0, early_stop=True)
    full = port(code, llr, **kw)
    got = port(code, llr[:batch], **kw)
    assert_same(got, [x[:batch] for x in full])
    assert_same(got, golden(code, llr[:batch], **kw))


@pytest.mark.parametrize("early_stop", [True, False])
def test_signed_zero_llrs_follow_golden(early_stop):
    """-0.0 is positive for the CN sign, the syndrome and the hard bit."""
    code = toy_code()
    llr = noisy_llrs(code, 16, 2.5, seed=12)
    rng = np.random.default_rng(13)
    pick = rng.random(llr.shape)
    llr[pick < 0.05] = 0.0
    llr[(pick >= 0.05) & (pick < 0.10)] = -0.0
    llr[(pick >= 0.10) & (pick < 0.12)] = 1e4
    llr[:4] = 5.0
    llr[:4, ::5] = -0.0
    kw = dict(iters=12, alpha=0.75, beta=0.0, early_stop=early_stop)
    got = port(code, llr, **kw)
    want = golden(code, llr, **kw)
    assert_same(got, want)
    if early_stop:
        np.testing.assert_array_equal(got[2][:4], 0)


def test_decode_api_dispatches_by_device():
    code = toy_code()
    llr = noisy_llrs(code, 12, 2.5, seed=14)
    want = golden(code, llr, iters=50, alpha=0.75, beta=0.0)
    got = decode(code, torch.from_numpy(llr))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    assert_same([x.numpy() for x in got], want)
    assert_same([x.numpy() for x in decode(code, llr, impl="torch",
                                           device="cpu")], want)
    # the kernel's builder takes its plain version only for CPU tensors
    got = build_cuda_decoder(code, "minsum", 50, 0.75, 0.0)(
        torch.from_numpy(llr))
    assert_same([x.numpy() for x in got], want)
    with pytest.raises(ValueError, match="CUDA device"):
        decode(code, llr, impl="cuda", device="cpu")


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(schedule="windowed"), "ported", id="windowed-ported"),
    pytest.param(dict(algo="bitflip"), "ported", id="bitflip-ported"),
    pytest.param(dict(impl="pallas"), "impl='cuda'", id="pallas"),
    pytest.param(dict(impl="jnp"), "impl='torch'", id="jnp"),
    pytest.param(dict(algo="wbf"), "ported", id="wbf-ported"),
    pytest.param(dict(impl="twophase"), "impl='auto', gives the same bits",
                 id="twophase"),
])
def test_unported_decoder_modes_raise(kw, item):
    """An impl the port does not have raises, naming its counterpart."""
    if item == "ported":
        # ported since (they raised before the hard-decision and windowed
        # decoders existed in the port): decode() runs them
        if "algo" in kw:  # bitflip / wbf, against golden
            code = toy_code()
            llr = noisy_llrs(code, 16, 4.0, seed=15)
            got = decode(code, llr, iters=20, device="cpu", **kw)
            want = decode_hard(code.H, llr, algo=kw["algo"], iters=20)
        else:  # windowed: a window of all rows is the plain decoder
            code = LdpcCode.from_base_graph(make_sc_base_graph(8, 8), 8,
                                            "sc_l8_z8")
            rng = np.random.default_rng(15)  # the all-zero codeword
            llr = (4.0 + 3.0 * rng.normal(size=(16, code.n))).astype(
                np.float32)
            got = decode(code, llr, iters=6, window=code.mb, device="cpu",
                         **kw)
            want = port(code, llr, iters=6, early_stop=False)
        assert_same([x.numpy() for x in got], want)
        return
    code = toy_code()
    with pytest.raises(NotImplementedError, match=item):
        decode(code, np.zeros((2, code.n), np.float32), device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(schedule="layered"),
    dict(algo="sumproduct"),
    dict(algo="sumproduct-fast"),
    dict(quant_bits=6),
], ids=["layered", "sumproduct", "sumproduct-fast", "quant"])
def test_ported_decoder_modes_run(kw):
    """The modes slices 2 and 3 ported (they raised before) decode NumPy
    input on the CPU like the JAX package's decode(); min-sum (float or
    quantized) and sumproduct-fast bit for bit with golden float32."""
    code = toy_code()
    llr = noisy_llrs(code, 24, 2.5, seed=15)
    got = [x.numpy() for x in decode(code, llr, iters=20, device="cpu",
                                     **kw)]
    schedule = kw.get("schedule", "flooding")
    algo = kw.get("algo", "minsum")
    exact = algo != "sumproduct"
    want = golden_decode(code.H, llr, algo=algo, iters=20, alpha=0.75,
                         schedule=schedule,
                         quant_bits=kw.get("quant_bits"),
                         dtype=np.float32 if exact else np.float64)
    if exact:
        assert_same(got, want)
    else:
        assert (got[0] == want[0]).all(axis=1).mean() >= 0.97
    assert 0 < got[1].mean()


def test_decode_refuses_twophase_keywords():
    """decode() has no two-phase knobs: early termination is single-pass."""
    code = toy_code()
    with pytest.raises(TypeError, match="phase1_iters"):
        decode(code, np.zeros((2, code.n), np.float32), phase1_iters=9,
               device="cpu")

