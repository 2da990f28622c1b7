"""Port decoder vs the JAX package: bit-exact on bits, ok and iters_used.

The plain PyTorch decoder (the CPU path of the port, and the oracle of
the CUDA kernel) is held against the golden float32 model and the jnp
reference decoder on the same NumPy LLRs (tests/test_torch_pallas.py
holds it against the Pallas kernel in interpret mode).  LLRs holding
+-0.0 are compared with golden only: the Pallas kernel reads sign bits
where golden reads `x < 0`.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch.codes_device import to_device
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import minsum_flood
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)


def toy_code(Z=8):
    return LdpcCode.from_base_graph(
        make_base_graph(4, 8, Z, seed=7), Z, f"toy{Z}")


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
    return [np.asarray(x) for x in jnp_build_decoder(code, "minsum", **kw)(llr)]


def assert_same(got, want):
    names = ("bits", "ok", "iters_used")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", ["toy", "wifi_z27", "judged"])
def test_to_device_carries_the_layout(name):
    code = {"toy": toy_code,
            "wifi_z27": lambda: LdpcCode.from_family("wifi", "2/3", 27),
            "judged": LdpcCode.judged}[name]()
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
    code = LdpcCode.from_family("wifi", "2/3", 27)
    llr = noisy_llrs(code, 8, 2.0, seed=6)
    kw = dict(iters=20, alpha=0.75, beta=0.0, early_stop=True)
    got = port(code, llr, **kw)
    assert 0 < got[1].mean() < 1
    assert_same(got, golden(code, llr, **kw))
    assert_same(got, jnp_ref(code, llr, **kw))


def test_judged_code():
    code = LdpcCode.judged()
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
    assert_same([x.numpy() for x in decode(code, llr, impl="torch")], want)
    # the kernel's wrapper takes its plain version only for CPU tensors
    got = minsum_flood(code, torch.from_numpy(llr), 50, 0.75, 0.0)
    assert_same([x.numpy() for x in got], want)
    with pytest.raises(ValueError, match="CUDA device"):
        decode(code, llr, impl="cuda")


@pytest.mark.parametrize("kw,item", [
    (dict(schedule="layered"), "K2"),
    (dict(algo="sumproduct"), "K3"),
    (dict(algo="sumproduct-fast"), "K4"),
    (dict(quant_bits=6), "K5"),
    (dict(impl="pallas"), "Queue 2"),
    (dict(impl="twophase"), "Queue 1 item 5"),
    (dict(algo="wbf"), "Queue 1 item 7"),
])
def test_unported_decoder_modes_raise(kw, item):
    code = toy_code()
    with pytest.raises(NotImplementedError, match=item):
        decode(code, np.zeros((2, code.n), np.float32), **kw)

