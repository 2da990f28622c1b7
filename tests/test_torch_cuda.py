"""The CUDA decode kernels on the card against the plain PyTorch version
and the golden model: K1 (flooding min-sum), K2 (layered min-sum), K4
(sumproduct-fast), K5 (fixed-point min-sum), K6 (compressed row state),
K8 (rescaled min-sum) and K9 (shift normalization), bit-exact with golden
float32, K3 (exact sum-product, both schedules) frame by frame and K7
(bf16 messages) against its plain version.

Marked `cuda`; each test skips without a CUDA device.  The file imports
no JAX (only the JAX package's NumPy golden model and code registry), so
on a machine with the card it runs without the JAX conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import (
    LAUNCHES, build_cuda_decoder, kernel_name)
from tpu_ldpc_torch.decode.flood_plan import compressed_plan, flood_plan
from tpu_ldpc_torch.decode.layered_plan import layered_plan
from tpu_ldpc_torch.decode.normalize import coordinates
from tpu_ldpc_torch.decode.reference import build_decoder

pytestmark = pytest.mark.cuda
# (algo, schedule, quantized) of the K1-K5 kernels
KERNEL_KEYS = [(algo, schedule, False)
               for algo in ("minsum", "sumproduct", "sumproduct-fast")
               for schedule in ("flooding", "layered")] + [
    ("minsum", "flooding", True), ("minsum", "layered", True)]

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
    before = LAUNCHES["minsum_flood"]
    got = build_cuda_decoder(code, "minsum", 50, 0.75, 0.0, "flooding",
                             early_stop, normalize=False)(llr)
    assert LAUNCHES["minsum_flood"] == before + 1
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
    before = LAUNCHES["minsum_layered"]
    got = build_cuda_decoder(code, "minsum", 25, 0.75, 0.0, "layered",
                             early_stop, normalize=False)(llr)
    assert LAUNCHES["minsum_layered"] == before + 1
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
    iters = 50 if schedule == "flooding" else 25
    for early_stop in (True, False):
        fn = build_cuda_decoder(code, "sumproduct-fast", iters,
                                schedule=schedule, early_stop=early_stop)
        before = LAUNCHES[fn.kernel]
        got = fn(llr)
        assert LAUNCHES[fn.kernel] == before + 1
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
            got = build_cuda_decoder(code, "sumproduct-fast", 10,
                                     schedule=schedule,
                                     early_stop=early_stop)(llr)
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
    iters = 50 if schedule == "flooding" else 25
    q = dict(quant_bits=bits, quant_step=step)
    for early_stop in (True, False):
        fn = build_cuda_decoder(code, "minsum", iters, 0.75, 0.0, schedule,
                                early_stop, **q)
        before = LAUNCHES[fn.kernel]
        got = fn(llr)
        assert LAUNCHES[fn.kernel] == before + 1
        want = build_decoder(code, "minsum", iters, 0.75, 0.0, schedule,
                             early_stop, **q)(llr)
        assert_same(got, want)
        assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
            ref.H, llr_np[:GOLDEN_ROWS], algo="minsum", iters=iters,
            alpha=0.75, schedule=schedule, dtype=np.float32,
            early_stop=early_stop, **q))


def test_quant_kernel_refuses_other_algos(cuda):
    """The C entry points return cudaErrorInvalidValue for quantization
    with a CN other than min-sum, with bf16 messages or with a step that
    is not a power of two, rescaled min-sum with another CN, a flooding or
    layered block shape, bucket or stride the code does not fit, and
    compressed rows of degree > 8 or a block the form does not take; the
    Python entry points raise first."""
    from tpu_ldpc_torch._build import load_library

    _, code = codes("judged", "1/2", 64)
    llr = torch.zeros((4, code.n), device=cuda)
    with pytest.raises(ValueError, match="minsum"):
        decode(code, llr, algo="sumproduct-fast", schedule="layered",
               quant_bits=6)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="minsum"):
        build_cuda_decoder(code, "sumproduct-fast", schedule="layered",
                           quant_bits=6)
    assert LAUNCHES == before
    out = torch.empty((4, code.n), dtype=torch.uint8, device=cuda)
    ok = torch.empty(4, dtype=torch.bool, device=cuda)
    iu = torch.empty(4, dtype=torch.int32, device=cuda)
    io = (llr.data_ptr(), out.data_ptr(), ok.data_ptr(), iu.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    E = code.layout.E

    def on_card(plan):
        arrays = [np.array(x) for x in plan.tables().values()]
        return [torch.from_numpy(x.view(np.int16) if x.dtype == np.uint16
                                 else x).to(cuda) for x in arrays]

    lib = load_library("bp_layered")
    lplan = layered_plan(code, tuple(int(s) for s in code.layout.edge_shift))
    ltabs = [t.data_ptr() or None for t in on_card(lplan)]
    shape = (lplan.bucket, lplan.group, lplan.cw_threads, lplan.threads,
             lplan.idx_stride, lplan.r_stride)
    for algo, bf16, quantized, step, (bucket, group, cw, threads, ei, er) in (
            (2, 0, 1, 0.25, shape), (0, 1, 1, 0.25, shape),
            # step not a power of two (the quantizer multiplies by the
            # exact reciprocal)
            (0, 0, 1, 0.3, shape),
            (0, 0, 0, 0.25, (8, 4, 64, 224, 54, 51)),  # threads < 4 x 64
            (0, 0, 0, 0.25, (8, 4, 64, 250, 54, 51)),  # not whole warps
            (0, 0, 0, 0.25, (12, 4, 64, 256, 54, 51)),  # no such bucket
            (0, 0, 0, 0.25, (8, 4, 32, 256, 54, 51)),  # a bucket walks r
            (0, 0, 0, 0.25, (8, 4, 64, 256, 53, 51)),  # odd uint16 stride
            (0, 0, 0, 0.25, (8, 4, 64, 256, 54, 50))):  # R stride < E
        err = lib.ldpc_bp_layered(
            algo, *io, *ltabs, None, 4, code.Z, code.mb, code.nb, E, bucket,
            group, cw, threads, ei, er, 5, 0.75, 0.0, 1, bf16, quantized,
            step, 31.0, 7.75, 31.75, stream)
        assert err != 0
    lib = load_library("bp_flood")
    plan = flood_plan(code, tuple(int(s) for s in code.layout.edge_shift))
    tabs = [t.data_ptr() for t in on_card(plan)]
    for algo, bf16, rescaled, quantized, step, bucket, threads in (
            (2, 0, 0, 1, 0.25, 8, 512), (1, 0, 1, 0, 0.25, 8, 512),
            (0, 1, 1, 0, 0.25, 8, 512), (0, 0, 1, 1, 0.25, 8, 512),
            (0, 0, 0, 1, 0.3, 8, 512),  # step not a power of two
            (0, 0, 0, 0, 0.25, 8, 256),  # fewer threads than checks
            (0, 0, 0, 0, 0.25, 8, 500),  # not whole warps
            (0, 0, 0, 0, 0.25, 12, 512)):  # no such bucket
        err = lib.ldpc_bp_flood(
            algo, *io, *tabs, None, 4, code.Z, code.mb, code.nb, E,
            bucket, threads, 5, 0.75, 0.0, 1, bf16, rescaled, 1.0 / 0.75,
            quantized, step, 31.0, 7.75, 31.75, stream)
        assert err != 0
    lib = load_library("bp_compressed")
    ctabs = [t.data_ptr() for t in on_card(compressed_plan(code))]
    for max_row_deg, one_check, threads in (
            (9, 1, 512),  # the sign byte holds 8 slots
            (7, 1, 480),  # fewer threads than checks
            (7, 0, 512),  # the walking form's block is 256
            (7, 1, 500)):  # not whole warps
        err = lib.ldpc_bp_compressed(
            *io, *ctabs, 4, code.Z, code.mb, code.nb, E, max_row_deg,
            one_check, threads, 5, 0.75, 0.0, 1, stream)
        assert err != 0


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_sumproduct_kernels_agree_with_plain_and_golden(cuda, schedule):
    ref, code = codes("judged", "1/2", 64)
    llr_np = noisy_llrs(code, 257, 1.75, seed=22)
    llr = torch.from_numpy(llr_np).to(cuda)
    fn = build_cuda_decoder(code, "sumproduct", 30, schedule=schedule)
    before = LAUNCHES[fn.kernel]
    got = fn(llr)
    assert LAUNCHES[fn.kernel] == before + 1
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
        got = build_cuda_decoder(code, "sumproduct", 8, schedule=schedule,
                                 early_stop=early_stop)(llr)
        want = build_decoder(code, "sumproduct", 8, schedule=schedule,
                             early_stop=early_stop)(llr)
        assert_same(got, want)


def test_decode_api_launches_the_kernel_and_checks_inputs(cuda):
    _, code = codes("judged", "1/2", 64)
    llr = torch.from_numpy(noisy_llrs(code, 64, 2.0, seed=3)).to(cuda)
    current = torch.cuda.current_device()
    for algo, schedule, quantized in KERNEL_KEYS:
        quant = dict(quant_bits=5) if quantized else {}
        name = kernel_name(algo, schedule, quantized=quantized)
        before = dict(LAUNCHES)
        got = decode(code, llr, algo=algo, schedule=schedule, iters=20,
                     **quant)
        # decode() runs in the code's own coordinates (PERF.md, K9)
        assert LAUNCHES[name] == before[name] + 1
        assert LAUNCHES[f"{name}_normalized"] == (
            before[f"{name}_normalized"])
        assert torch.cuda.current_device() == current
        want = decode(code, llr, algo=algo, schedule=schedule, iters=20,
                      impl="torch", **quant)
        if algo != "sumproduct":
            assert_same(got, want)
        else:
            assert frame_agreement(got, want) >= 0.99
    before = LAUNCHES["minsum_flood"]
    assert_same(decode(code, llr.cpu().numpy()), decode(code, llr))
    assert LAUNCHES["minsum_flood"] == before + 2  # NumPy input: the card
    layered = build_cuda_decoder(code, schedule="layered")
    with pytest.raises(TypeError):
        layered(llr.double())
    with pytest.raises(ValueError, match="contiguous"):
        layered(torch.cat([llr, llr], 1)[:, ::2])
    with pytest.raises(ValueError):
        build_cuda_decoder(code)(llr[:, :100].contiguous())
    empty = layered(llr[:0])
    assert empty[0].shape == (0, code.n)


# ---- slice 4: K6 compressed row state, K7 bf16 messages, K8 rescaled
# min-sum, K9 shift normalization ----

def test_compressed_and_rescaled_kernels_vs_golden(cuda):
    """K6 and K8 on the judged code, ET on and off, +-0.0 and 1e4 LLRs
    included: bit-exact with the plain version and golden float32 (K8
    with golden's rescaled contract; K6 equals the standard decoder)."""
    ref, code = codes("judged", "1/2", 64)
    llr_np = special_llrs(code, 2.0)
    llr = torch.from_numpy(llr_np).to(cuda)
    for kw in (dict(compressed=True), dict(rescaled=True),
               dict(rescaled=True, normalize=False)):
        for early_stop in (True, False):
            fn = build_cuda_decoder(code, "minsum", 50, 0.75, 0.0,
                                    "flooding", early_stop, **kw)
            before = LAUNCHES[fn.kernel]
            got = fn(llr)
            assert LAUNCHES[fn.kernel] == before + 1
            assert_same(got, build_decoder(code, "minsum", 50, 0.75, 0.0,
                                           "flooding", early_stop, **kw)(llr))
            assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
                ref.H, llr_np[:GOLDEN_ROWS], iters=50, alpha=0.75,
                dtype=np.float32, early_stop=early_stop,
                rescaled=kw.get("rescaled", False)))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast", "sumproduct"])
def test_bf16_kernels_vs_plain(cuda, algo, schedule):
    """K7: bit-exact with the plain bf16 version (exact sum-product:
    >= 0.99 of frames), normalized and not, ET on and off; min-sum within
    the >= 0.97 contract of float32."""
    _, code = codes("judged", "1/2", 64)
    llr = torch.from_numpy(special_llrs(code, 2.0)).to(cuda)
    iters = 50 if schedule == "flooding" else 25
    for normalize in (True, False):
        for early_stop in (True, False):
            args = (code, algo, iters, 0.75, 0.0, schedule, early_stop)
            fn = build_cuda_decoder(*args, normalize=normalize,
                                    msg_dtype=torch.bfloat16)
            assert fn.kernel.endswith("_bf16")
            got = fn(llr)
            want = build_decoder(*args, msg_dtype=torch.bfloat16)(llr)
            if algo == "sumproduct":
                assert frame_agreement(got, want) >= 0.99
            else:
                assert_same(got, want)
            if algo == "minsum":
                f32 = build_cuda_decoder(*args)(llr)
                assert min(agreement(got, f32)) >= 0.97


@pytest.mark.parametrize("family,rate,Z,ebn0", CODES)
def test_normalized_kernels_vs_golden(cuda, family, rate, Z, ebn0):
    """K9 on and off for K1, K2, K4 and K5, ET on and off: bit-exact
    with each other and with golden float32."""
    ref, code = codes(family, rate, Z)
    llr_np = special_llrs(code, ebn0)
    llr = torch.from_numpy(llr_np).to(cuda)
    for algo, schedule, q in (("minsum", "flooding", {}),
                              ("minsum", "layered", {}),
                              ("sumproduct-fast", "flooding", {}),
                              ("minsum", "layered", dict(quant_bits=6,
                                                         quant_step=0.25))):
        iters = 50 if schedule == "flooding" else 25
        for early_stop in (True, False):
            args = (code, algo, iters, 0.75, 0.0, schedule, early_stop)
            on = build_cuda_decoder(*args, normalize=True, **q)
            before = LAUNCHES[f"{on.kernel}_normalized"]
            got = on(llr)
            assert LAUNCHES[f"{on.kernel}_normalized"] == before + 1
            assert_same(got, build_cuda_decoder(*args, normalize=False,
                                                **q)(llr))
            assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
                ref.H, llr_np[:GOLDEN_ROWS], algo=algo, iters=iters,
                alpha=0.75, schedule=schedule, dtype=np.float32,
                early_stop=early_stop, **q))


# ---- slice 5: the flooding body by row-degree bucket ----

def wide_codes():
    """A row of degree 40 (above the largest bucket, 32): the two-pass
    kernel."""
    B = np.full((2, 40), -1)
    B[0, :] = np.arange(40) % 5
    B[1, :4] = [1, 2, 3, 4]
    return (JaxLdpcCode.from_base_graph(B, 5, "deg40"),
            LdpcCode.from_base_graph(B, 5, "deg40"))


BUCKET_CODES = [("judged", "1/2", 64, 2.0, 8), ("wifi", "3/4", 27, 2.5, 16),
                ("wimax", "5/6", 48, 3.0, 32), ("wimax", "1/2", 96, 2.0, 0),
                ("deg40", None, 5, 4.0, 0)]


@pytest.mark.parametrize("family,rate,Z,ebn0,bucket", BUCKET_CODES)
def test_flood_buckets_vs_plain_and_golden(cuda, family, rate, Z, ebn0,
                                           bucket):
    """One code per instantiation of the flooding body: judged (row
    degree 7 -> 8 slots), wifi 3/4 Z=27 (16 -> 16), wimax 5/6 Z=48 (20 ->
    32), and the two-pass kernel for 1152 checks and for a row of degree
    40.  Min-sum, sumproduct-fast, fixed-point and rescaled min-sum, in
    plain and normalized coordinates, ET on and off, the +-0.0 and 1e4
    rows included: bit-exact with the plain version and with golden
    float32 (golden's per-frame loops are slow: its first rows); bf16
    messages bit-exact with the plain version; exact sum-product on >=
    0.99 of frames.  The two-pass kernel's rows of at most 32 slots send
    from the first pass's signs (<name>_one_gather counts the launch)
    under every CN update but exact sum-product; the row of 40 and exact
    sum-product recompute q."""
    if family == "deg40":
        ref, code = wide_codes()
        rng = np.random.default_rng(4)
        llr_np = (2.0 + 1.5 * rng.normal(size=(257, code.n))).astype(
            np.float32)
        llr_np[1, ::3] = -0.0
        llr_np[2, ::5] = 1e4
    else:
        ref, code = codes(family, rate, Z)
        llr_np = special_llrs(code, ebn0)
    assert flood_plan(code, coordinates(code, False)[0]).bucket == bucket
    llr = torch.from_numpy(llr_np).to(cuda)
    for algo, q in (("minsum", {}), ("sumproduct-fast", {}),
                    ("minsum", dict(quant_bits=6, quant_step=0.25)),
                    ("minsum", dict(rescaled=True)),
                    ("minsum", dict(msg_dtype=torch.bfloat16)),
                    ("sumproduct-fast", dict(msg_dtype=torch.bfloat16)),
                    ("sumproduct", {})):
        one_gather = (bucket == 0 and family != "deg40"
                      and algo != "sumproduct")
        for normalize in (False, True):
            for early_stop in (True, False):
                args = (code, algo, 50, 0.75, 0.0, "flooding", early_stop)
                fn = build_cuda_decoder(*args, normalize=normalize, **q)
                names = (fn.kernel, f"{fn.kernel}_one_gather")
                before = [LAUNCHES[name] for name in names]
                got = fn(llr)
                assert [LAUNCHES[name] for name in names] == [
                    before[0] + 1, before[1] + one_gather]
                want = build_decoder(*args, normalize=normalize, **q)(llr)
                if algo == "sumproduct":  # tanhf / logf
                    assert frame_agreement(got, want) >= 0.99
                    continue
                assert_same(got, want)
                if "msg_dtype" in q:
                    continue
                assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
                    ref.H, llr_np[:GOLDEN_ROWS], algo=algo, iters=50,
                    alpha=0.75, dtype=np.float32, early_stop=early_stop,
                    **q))


@pytest.mark.parametrize("family,rate,Z,ebn0,bucket", BUCKET_CODES)
def test_layered_buckets_vs_plain_and_golden(cuda, family, rate, Z, ebn0,
                                             bucket):
    """The layered body on the same codes: judged (8 slots, 4 codewords a
    block), wifi 3/4 Z=27 (16), wimax 5/6 Z=48 (32), wimax 1/2 Z=96
    (16, 2 codewords a block) and the two-pass form for a row of degree
    40.  Min-sum, sumproduct-fast and fixed-point, plain and normalized
    coordinates, ET on and off, 257 frames (a partial last block), the
    +-0.0 and 1e4 rows included: bit-exact with the plain version and
    with golden float32 (its first rows)."""
    if family == "deg40":
        ref, code = wide_codes()
        rng = np.random.default_rng(4)
        llr_np = (2.0 + 1.5 * rng.normal(size=(257, code.n))).astype(
            np.float32)
        llr_np[1, ::3] = -0.0
        llr_np[2, ::5] = 1e4
    else:
        ref, code = codes(family, rate, Z)
        llr_np = special_llrs(code, ebn0)
    plan = layered_plan(code, coordinates(code, False)[0])
    assert plan.bucket == (bucket if bucket or family == "deg40" else 16)
    llr = torch.from_numpy(llr_np).to(cuda)
    for algo, q in (("minsum", {}), ("sumproduct-fast", {}),
                    ("minsum", dict(quant_bits=6, quant_step=0.25))):
        for normalize in (False, True):
            for early_stop in (True, False):
                args = (code, algo, 25, 0.75, 0.0, "layered", early_stop)
                fn = build_cuda_decoder(*args, normalize=normalize, **q)
                before = LAUNCHES[fn.kernel]
                got = fn(llr)
                assert LAUNCHES[fn.kernel] == before + 1
                assert_same(got, build_decoder(*args, normalize=normalize,
                                               **q)(llr))
                assert_same([x[:GOLDEN_ROWS] for x in got], golden_decode(
                    ref.H, llr_np[:GOLDEN_ROWS], algo=algo, iters=25,
                    alpha=0.75, schedule="layered", dtype=np.float32,
                    early_stop=early_stop, **q))


# ---- slice 8: hard-decision and windowed decoders (plain PyTorch on the
# card) ----

def test_hard_decoders_card_equals_cpu(cuda):
    """bitflip and WBF on the judged code: the card's (bits, ok,
    iters_used) equal the CPU's on the same AWGN and BSC LLRs (BSC: WBF's
    energies tie, so argmax's first-index rule decides on both)."""
    from tpu_ldpc_torch.channel.bsc import bsc_llrs_from_flips
    from tpu_ldpc_torch.decode.hard import build_hard_decoder

    _, code = codes("judged", "1/2", 64)
    rng = np.random.default_rng(8)
    c = torch.from_numpy(golden_encode(
        code.H, rng.integers(0, 2, (128, code.k)).astype(np.uint8)))
    bsc = bsc_llrs_from_flips(c, torch.from_numpy(rng.random(c.shape)
                                                  < 0.002), 0.002)
    for llr in (torch.from_numpy(noisy_llrs(code, 128, 4.0, seed=9)), bsc):
        for algo in ("bitflip", "wbf"):
            want = build_hard_decoder(code, algo, 50, device="cpu")(llr)
            got = build_hard_decoder(code, algo, 50, device=cuda)(
                llr.to(cuda))
            assert_same(got, want)


def test_windowed_card_equals_cpu(cuda):
    """The windowed decoder on an SC chain (L=16, Z=16), sliding (W=6)
    and full windows, both sweeps: min-sum and sumproduct-fast bit for
    bit between the card and the CPU."""
    from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
    from tpu_ldpc_torch.decode.windowed import build_windowed_decoder

    code = LdpcCode.from_base_graph(make_sc_base_graph(16, 16), 16,
                                    "sc_l16_z16")
    rng = np.random.default_rng(10)  # the all-zero codeword at 1.8 dB
    sigma2 = 1.0 / (2 * code.rate * 10 ** 0.18)
    y = 1.0 + np.sqrt(sigma2) * rng.normal(size=(128, code.n))
    llr = torch.from_numpy((2.0 / sigma2 * y).astype(np.float32))
    for window in (6, code.mb):
        for sweep in ("flooding", "layered"):
            for algo in ("minsum", "sumproduct-fast"):
                kw = dict(algo=algo, sweep=sweep)
                want = build_windowed_decoder(code, window, 3, device="cpu",
                                              **kw)(llr)
                got = build_windowed_decoder(code, window, 3, device=cuda,
                                             **kw)(llr.to(cuda))
                assert_same(got, want)


def test_trapping_harvest_on_card_equals_golden(cuda):
    """harvest_failures with its default decoder (K1 on the card) finds,
    failure for failure, what golden float32 min-sum on the CPU finds in
    the first chunk of the punctured NR mother (nr2_r15_z64, 1.2 dB, 2Z
    erased, 50 it, the paired-seed draws of the JAX package's census,
    which tests/test_torch_trapping.py holds equal on the CPU)."""
    from tpu_ldpc.codes.nrlike import nrlike_code
    from tpu_ldpc_torch.codes.trapping import harvest_failures

    ref = nrlike_code("1/5", 64, bg=2)
    code = LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)
    kw = dict(iters=50, alpha=0.75, target=10**9, max_frames=256, chunk=256,
              n_punct=2 * code.Z)

    def golden(llr):
        return golden_decode(ref.H, llr, iters=50, alpha=0.75,
                             dtype=np.float32)

    LAUNCHES["minsum_flood"] = 0
    got, frames = harvest_failures(code, 1.2, **kw)
    assert LAUNCHES["minsum_flood"] == 1 and frames == 256
    want, _ = harvest_failures(code, 1.2, decode=golden, **kw)
    assert [dataclasses.astuple(f) for f in got] == [
        dataclasses.astuple(f) for f in want]
    assert len(got) > 0


def test_impulse_probe_on_card_finds_toy_dmin(cuda):
    """estimate_dmin_impulse with its default decoder (exact sum-product,
    K3, on the card) finds tests/test_dmin.py's toy code's d_min 4."""
    from tpu_ldpc_torch.codes import make_base_graph
    from tpu_ldpc_torch.codes.dmin import estimate_dmin_impulse

    code = LdpcCode.from_base_graph(make_base_graph(4, 6, 4, seed=5), 4)
    LAUNCHES["sumproduct_flood"] = 0
    ub, st = estimate_dmin_impulse(code)
    assert LAUNCHES["sumproduct_flood"] == 1
    assert ub == 4 and st["converged_nonzero"] > 0


def test_host_flood_smem_bytes_equals_the_library(cuda):
    """decode/flood_plan.py's flood_smem_bytes (the routing decision of
    build_decode_fn(mesh=...)) equals the C entry point on the judged
    code and one code of each bucket, float32 and bf16 messages."""
    from tpu_ldpc_torch._build import load_library
    from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
    from tpu_ldpc_torch.decode.flood_plan import (
        code_flood_smem_bytes, flood_smem_bytes)

    lib = load_library("bp_flood")
    cases = [codes(*c[:3])[1] for c in CODES]  # buckets 8, 16, 32
    cases.append(LdpcCode.from_family("wimax", "1/2", 96))  # bucket 0
    cases.append(LdpcCode.from_base_graph(make_sc_base_graph(128, 64), 64,
                                          "sc_l128_z64"))
    for code in cases:
        lay = code.layout
        plan = flood_plan(code, tuple(int(s) for s in lay.edge_shift))
        for bf16 in (0, 1):
            want = lib.ldpc_bp_flood_smem_bytes(code.Z, code.mb, code.nb,
                                                lay.E, plan.bucket, bf16)
            assert flood_smem_bytes(code.Z, code.mb, code.nb, lay.E,
                                    plan.bucket, bool(bf16)) == want
        assert code_flood_smem_bytes(code) == lib.ldpc_bp_flood_smem_bytes(
            code.Z, code.mb, code.nb, lay.E, plan.bucket, 0)


def test_world_one_nccl_run_ber_equals_run_ber(cuda):
    """run_ber over a world-1 NCCL mesh (made in this process, no
    torchrun) equals run_ber without a mesh field for field: rank 0 draws
    the single-device streams and the all_reduce of one rank is exact."""
    import torch.distributed as dist

    from tpu_ldpc_torch.dist import init_distributed, make_mesh
    from tpu_ldpc_torch.sim.mc import DecodeCfg, run_ber

    assert not dist.is_initialized()
    init_distributed(device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        code = LdpcCode.judged()
        kw = dict(cfg=DecodeCfg(), batch=1024, target_frame_errors=50,
                  max_frames=65536, seed=3, device="cuda")
        want = run_ber(code, [2.0, 2.5], **kw)
        got = run_ber(code, [2.0, 2.5], mesh=mesh, **kw)
        for g, w in zip(got, want):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            g.pop("wall_s"), w.pop("wall_s")
            assert g == w
    finally:
        dist.destroy_process_group()


def test_bench_decode_judged_b4096(cuda, capsys):
    """The throughput CLI's timed path on the card: the judged code at
    b=4096 (flooding min-sum, 50 iterations, ET off) launches K1 and
    gives a finite, positive time; the CLI's record names the card."""
    import json
    import math

    from tpu_ldpc_torch.cli.bench import bench_decode, main

    code = LdpcCode.judged()
    before = LAUNCHES["minsum_flood"]
    dt, thpt = bench_decode(code, batch=4096, reps=5, device="cuda")
    assert LAUNCHES["minsum_flood"] > before
    assert math.isfinite(dt) and dt > 0
    assert thpt == 4096 * code.k / dt
    capsys.readouterr()
    rec = main(["--json", "--reps", "5"])
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["backend"] == "cuda" and rec["n_devices"] >= 1
    assert rec["device_kind"] == torch.cuda.get_device_name()
    assert math.isfinite(rec["ms_per_batch"]) and rec["ms_per_batch"] > 0
