"""The CUDA decode kernels on the card against the plain PyTorch version
and the golden model: K1 (flooding min-sum), K2 (layered min-sum), K4
(sumproduct-fast) and K5 (fixed-point min-sum), both schedules, bit-exact
with golden float32, K3 (exact sum-product, both schedules) frame by
frame, and two-phase decoding bit-identical to single-pass ET.

Marked `cuda`; each test skips without a CUDA device.  The file imports
no JAX (only the JAX package's NumPy golden model and code registry), so
on a machine with the card it runs without the JAX conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import (
    WRAPPERS, minsum_flood, minsum_layered)
from tpu_ldpc_torch.decode.reference import build_decoder
from tpu_ldpc_torch.decode.twophase import build_twophase_decoder

pytestmark = pytest.mark.cuda

CODES = [("judged", "1/2", 64, 2.0), ("wifi", "2/3", 27, 2.0),
         ("wimax", "5/6", 96, 3.0)]
GOLDEN_ROWS = 48  # rows of special_llrs (the +-0.0 and 1e4 rows first)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (torch.cuda.is_available() is False): "
                    "the nvcc-built sm_90a kernels need an NVIDIA H100 and "
                    "the CUDA toolkit")
    return torch.device("cuda")


def codes(family, rate, Z):
    """(JAX package's code, its port twin built through from_base_graph)."""
    ref = (JaxLdpcCode.judged() if family == "judged"
           else JaxLdpcCode.from_family(family, rate, Z))
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def special_llrs(code, ebn0_db):
    llr = noisy_llrs(code, 257, ebn0_db, seed=21)
    llr[1, ::3] = -0.0
    llr[2, ::5] = 1e4
    return llr


def numpy_of(out):
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in out]


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), numpy_of(got),
                          numpy_of(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def agreement(got, want):
    """(share of frames with equal bits, share with equal ok)."""
    (gb, gok, _), (wb, wok, _) = numpy_of(got), numpy_of(want)
    return (gb == wb).all(axis=1).mean(), (gok == wok).mean()


def frame_agreement(got, want):
    """Share of frames whose bits, ok and iters_used all agree."""
    (gb, gok, giu), (wb, wok, wiu) = numpy_of(got), numpy_of(want)
    return ((gb == wb).all(axis=1) & (gok == wok) & (giu == wiu)).mean()


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("family,rate,Z,ebn0", CODES)
def test_kernel_bitexact_vs_plain_and_golden(cuda, family, rate, Z, ebn0,
                                             early_stop):
    ref, code = codes(family, rate, Z)
    llr_np = special_llrs(code, ebn0)
    llr = torch.from_numpy(llr_np).to(cuda)
    before = minsum_flood.launches
    got = minsum_flood(code, llr, 50, 0.75, 0.0, early_stop)
    assert minsum_flood.launches == before + 1
    want = build_decoder(code, "minsum", 50, 0.75, 0.0, "flooding",
                         early_stop)(llr)
    assert_same(got, want)
    assert_same(got, golden_decode(ref.H, llr_np, iters=50, alpha=0.75,
                                   dtype=np.float32, early_stop=early_stop))


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("family,rate,Z,ebn0", CODES)
def test_layered_kernel_bitexact_vs_plain_and_golden(cuda, family, rate, Z,
                                                     ebn0, early_stop):
    ref, code = codes(family, rate, Z)
    llr_np = special_llrs(code, ebn0)
    llr = torch.from_numpy(llr_np).to(cuda)
    before = minsum_layered.launches
    got = minsum_layered(code, llr, 25, 0.75, 0.0, early_stop)
    assert minsum_layered.launches == before + 1
    want = build_decoder(code, "minsum", 25, 0.75, 0.0, "layered",
                         early_stop)(llr)
    assert_same(got, want)
    assert_same(got, golden_decode(ref.H, llr_np, iters=25, alpha=0.75,
                                   schedule="layered", dtype=np.float32,
                                   early_stop=early_stop))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("family,rate,Z,ebn0", CODES)
def test_spfast_kernels_bitexact_vs_plain_and_golden(cuda, family, rate, Z,
                                                     ebn0, schedule):
    """K4, ET on and off, +-0.0 and 1e4 LLRs included."""
    ref, code = codes(family, rate, Z)
    llr_np = special_llrs(code, ebn0)
    llr = torch.from_numpy(llr_np).to(cuda)
    wrapper = WRAPPERS[("sumproduct-fast", schedule, False)]
    iters = 50 if schedule == "flooding" else 25
    for early_stop in (True, False):
        before = wrapper.launches
        got = wrapper(code, llr, iters, early_stop=early_stop)
        assert wrapper.launches == before + 1
        want = build_decoder(code, "sumproduct-fast", iters,
                             schedule=schedule, early_stop=early_stop)(llr)
        assert_same(got, want)
        # golden's per-frame loops are slow: its share is the first rows
        assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
            ref.H, llr_np[:GOLDEN_ROWS], algo="sumproduct-fast",
            iters=iters, schedule=schedule, dtype=np.float32,
            early_stop=early_stop))


def test_spfast_kernels_on_low_degree_rows(cuda):
    """Rows of degree 1, 2, 3 and 4 (a hand-made base graph, random
    LLRs): the degree-1 and degree-2 branches of the CN update."""
    B = np.array([[0, -1, -1, -1, -1, -1], [1, 2, -1, -1, -1, -1],
                  [-1, 3, 0, 5, -1, -1], [2, -1, 1, -1, 4, 0]])
    ref = JaxLdpcCode.from_base_graph(B, 7, "lowdeg")
    code = LdpcCode.from_base_graph(B, 7, "lowdeg")
    rng = np.random.default_rng(3)
    llr_np = (rng.normal(0.8, 2.0, (300, code.n)) * 2).astype(np.float32)
    llr = torch.from_numpy(llr_np).to(cuda)
    for schedule in ("flooding", "layered"):
        for early_stop in (True, False):
            got = WRAPPERS[("sumproduct-fast", schedule, False)](
                code, llr, 10, early_stop=early_stop)
            assert_same(got, build_decoder(code, "sumproduct-fast", 10,
                                           schedule=schedule,
                                           early_stop=early_stop)(llr))
            assert_same(got, golden_decode(
                ref.H, llr_np, algo="sumproduct-fast", iters=10,
                schedule=schedule, dtype=np.float32, early_stop=early_stop))


@pytest.mark.parametrize("bits,step", [(6, 0.25), (4, 0.5)])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("family,rate,Z,ebn0", CODES)
def test_quant_kernels_bitexact_vs_plain_and_golden(cuda, family, rate, Z,
                                                    ebn0, schedule, bits,
                                                    step):
    """K5, ET on and off, +-0.0 and 1e4 LLRs included."""
    ref, code = codes(family, rate, Z)
    llr_np = special_llrs(code, ebn0)
    llr = torch.from_numpy(llr_np).to(cuda)
    wrapper = WRAPPERS[("minsum", schedule, True)]
    iters = 50 if schedule == "flooding" else 25
    q = dict(quant_bits=bits, quant_step=step)
    for early_stop in (True, False):
        before = wrapper.launches
        got = wrapper(code, llr, iters, 0.75, 0.0, early_stop, **q)
        assert wrapper.launches == before + 1
        want = build_decoder(code, "minsum", iters, 0.75, 0.0, schedule,
                             early_stop, **q)(llr)
        assert_same(got, want)
        assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
            ref.H, llr_np[:GOLDEN_ROWS], algo="minsum", iters=iters,
            alpha=0.75, schedule=schedule, dtype=np.float32,
            early_stop=early_stop, **q))


def test_quant_kernel_refuses_other_algos(cuda):
    """The C entry point returns cudaErrorInvalidValue for quantization
    with a CN other than min-sum; the Python entry points raise first."""
    from tpu_ldpc_torch._build import load_library
    from tpu_ldpc_torch.codes_device import to_device
    from tpu_ldpc_torch.decode.cuda_bp import (
        _decode, minsum_quant_layered, wrapper_for)

    _, code = codes("judged", "1/2", 64)
    llr = torch.zeros((4, code.n), device=cuda)
    with pytest.raises(ValueError, match="minsum"):
        decode(code, llr, algo="sumproduct-fast", schedule="layered",
               quant_bits=6)
    with pytest.raises(ValueError, match="quant_bits=6"):
        wrapper_for("sumproduct-fast", "layered", quant_bits=6)
    launches = minsum_quant_layered.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        _decode(minsum_quant_layered, "sumproduct-fast", "layered", code,
                llr, 5, 0.75, 0.0, True, (6, 0.25, 8))
    assert minsum_quant_layered.launches == launches
    lib = load_library("bp_layered")
    dc = to_device(code, cuda)
    out = torch.empty((4, code.n), dtype=torch.uint8, device=cuda)
    ok = torch.empty(4, dtype=torch.bool, device=cuda)
    iu = torch.empty(4, dtype=torch.int32, device=cuda)
    err = lib.ldpc_bp_layered(
        2, llr.data_ptr(), out.data_ptr(), ok.data_ptr(), iu.data_ptr(),
        dc.edge_col.data_ptr(), dc.edge_shift.data_ptr(),
        dc.row_ptr.data_ptr(), 4, code.Z, code.mb, code.nb, dc.E, 5, 0.75,
        0.0, 1, 1, 0.25, 31.0, 7.75, 31.75,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_kernels_agree_with_plain_and_golden(cuda, schedule):
    ref, code = codes("judged", "1/2", 64)
    llr_np = noisy_llrs(code, 257, 1.75, seed=22)
    llr = torch.from_numpy(llr_np).to(cuda)
    wrapper = WRAPPERS[("sumproduct", schedule, False)]
    before = wrapper.launches
    got = wrapper(code, llr, 30)
    assert wrapper.launches == before + 1
    plain = build_decoder(code, "sumproduct", 30, schedule=schedule)(llr)
    # the same card: at most 2 of 257 frames may split on rounding
    assert frame_agreement(got, plain) >= 0.99
    gold = golden_decode(ref.H, llr_np, algo="sumproduct", iters=30,
                         schedule=schedule)
    assert min(agreement(got, gold)) >= 0.95
    assert 0 < numpy_of(got)[1].mean() < 1


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_kernels_on_extreme_llrs(cuda, schedule):
    """+-1e30, zeros and 1e-30: the kernels give the plain version's
    bits, ok and iters_used (whose posterior the CPU tests hold finite)."""
    _, code = codes("wifi", "2/3", 27)
    n = code.n
    llr = torch.from_numpy(np.stack([
        np.full(n, 1e30, np.float32), np.full(n, -1e30, np.float32),
        np.zeros(n, np.float32),
        np.asarray([1e20 if i % 2 else -1e20 for i in range(n)], np.float32),
        np.asarray([0.0 if i % 3 else 1e-30 for i in range(n)], np.float32),
    ])).to(cuda)
    for early_stop in (True, False):
        got = WRAPPERS[("sumproduct", schedule, False)](code, llr, 8,
                                                 early_stop=early_stop)
        want = build_decoder(code, "sumproduct", 8, schedule=schedule,
                             early_stop=early_stop)(llr)
        assert_same(got, want)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_quant_and_spfast_twophase_on_card(cuda, schedule):
    """Two-phase with quantization and with sumproduct-fast on the card:
    bit-identical to single-pass ET."""
    _, code = codes("judged", "1/2", 64)
    llr = torch.from_numpy(noisy_llrs(code, 1024, 2.0, seed=24)).to(cuda)
    iters, k = (50, 20) if schedule == "flooding" else (25, 9)
    for kw in (dict(quant_bits=5), dict(algo="sumproduct-fast")):
        single = decode(code, llr, schedule=schedule, iters=iters, **kw)
        got = decode(code, llr, schedule=schedule, iters=iters,
                     impl="twophase", phase1_iters=k, compact_budget=512,
                     **kw)
        assert_same(got, single)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_twophase_on_card_bit_identical(cuda, schedule):
    _, code = codes("judged", "1/2", 64)
    llr = torch.from_numpy(noisy_llrs(code, 1024, 2.0, seed=23)).to(cuda)
    iters, k = (50, 20) if schedule == "flooding" else (25, 9)
    single = decode(code, llr, schedule=schedule, iters=iters)
    for budget in (512, 1):  # compacted, and the full-batch fallback
        fn = build_twophase_decoder(code, iters, k, budget,
                                    report_fallback=True, schedule=schedule)
        *got, n_unconv = fn(llr)
        assert (n_unconv > budget) == (budget == 1)
        assert_same(got, single)


def test_decode_api_launches_the_kernel_and_checks_inputs(cuda):
    _, code = codes("judged", "1/2", 64)
    llr = torch.from_numpy(noisy_llrs(code, 64, 2.0, seed=3)).to(cuda)
    current = torch.cuda.current_device()
    for (algo, schedule, quantized), wrapper in WRAPPERS.items():
        quant = dict(quant_bits=5) if quantized else {}
        before = wrapper.launches
        got = decode(code, llr, algo=algo, schedule=schedule, iters=20,
                     **quant)
        assert wrapper.launches == before + 1
        assert torch.cuda.current_device() == current
        want = decode(code, llr, algo=algo, schedule=schedule, iters=20,
                      impl="torch", **quant)
        if algo != "sumproduct":
            assert_same(got, want)
        else:
            assert frame_agreement(got, want) >= 0.99
    before = minsum_flood.launches
    assert_same(decode(code, llr.cpu().numpy()), decode(code, llr))
    assert minsum_flood.launches == before + 2  # NumPy input goes to the card
    with pytest.raises(TypeError):
        minsum_layered(code, llr.double())
    with pytest.raises(ValueError, match="contiguous"):
        minsum_layered(code, torch.cat([llr, llr], 1)[:, ::2])
    with pytest.raises(ValueError):
        minsum_flood(code, llr[:, :100].contiguous())
    empty = minsum_layered(code, llr[:0])
    assert empty[0].shape == (0, code.n)
