"""The flooding decoder's device-memory form, K1g (``bp_flood_gmem_kernel``
in ``csrc/bp_flood.cu``): the codes that take it, its order of operations
on the CPU, and (marked ``cuda``, skipped without a card) the kernel
itself.

- The route: a flooding decode whose block state exceeds
  ``SMEM_LIMIT_BYTES`` takes K1g, with ``flood_gmem_state_bytes`` of
  device memory a codeword; NR BG1 at Z = 384 (K_cb = 8448) and the
  NR-like registry cells above the limit at the NR lifting sizes go
  there, every other cell keeps the shared-memory kernel and its bucket.
- The placement (``gmem_placement``): every one of those cells keeps L
  and P in shared memory beside the row tables, R alone in the scratch,
  on blocks of ``GMEM_SHARED_LP_THREADS``; a code whose L and P do not
  fit keeps them in the scratch, on blocks of ``GENERIC_THREADS``.
- A torch-op decoder in K1g's order of operations
  (``test_torch_flood_tables.table_decoder`` on the two-pass path: each
  row from ``row_ptr`` / ``e_p`` / ``e_r`` / ``e_shift``, the VN sum from
  the plan's ``vn_info`` in ascending block-row order), reading only the
  plan's tables, equals the plain decoder's posterior and the
  golden model bit for bit on a punctured NR-like code, min-sum and
  sumproduct-fast, ET on and off, with zero and -0.0 LLRs.
- On the card: K1g in both placements against the shared-memory kernel
  and the plain decoder on codes forced onto the route, and on Z = 384
  itself; the MC
  batch kernels at Z = 384; ``decode()`` and the MC step launching K1g;
  the span ``ldpc.decode.gmem``; the C entry's refusals.  On a machine
  with the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_flood_gmem.py -q
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes.nrlike import (
    M_BY_RATE, M_BY_RATE2, nrlike_adapt, nrlike_code)
from tpu_ldpc_torch.decode import cuda_bp
from tpu_ldpc_torch.decode.flood_plan import (
    GENERIC_THREADS, GMEM_SHARED_LP_THREADS, GMEM_STATE_ALIGN,
    SIGN_SLOTS, SMEM_LIMIT_BYTES, VN_BASE_BITS, choose_bucket,
    code_flood_smem_bytes, flood_gmem_smem_bytes, flood_gmem_state_bytes,
    flood_plan, flood_smem_bytes, gmem_placement, one_gather)
from tpu_ldpc_torch.decode.normalize import coordinates
from tpu_ldpc_torch.decode.reference import build_decoder
from test_torch_flood_tables import table_decoder

torch.set_num_threads(1)

# TS 38.212 Table 5.3.2-1: Z = a * 2^j, a in {2, 3, 5, 7, 9, 11, 13, 15}
NR_LIFTS = sorted({a << j for a in (2, 3, 5, 7, 9, 11, 13, 15)
                   for j in range(8) if a << j <= 384})
# the smallest NR lifting size at which each NR-like cell's flooding
# state outgrows one block's shared memory (None: never up to 384)
FIRST_GMEM_Z = {(1, "1/2"): 176, (1, "2/3"): 256, (1, "3/4"): 288,
                (1, "5/6"): 320, (2, "1/5"): 176, (2, "2/7"): 240,
                (2, "2/5"): 320, (2, "1/2"): None, (2, "2/3"): None}
CELLS = [(1, rate) for rate in M_BY_RATE] + [(2, rate) for rate in M_BY_RATE2]
ALPHA = 0.75


def state_bytes(Z, nb, E):
    """L and P (4 B a variable each) and R (4 B a message), rounded up to
    GMEM_STATE_ALIGN: written out apart from flood_gmem_state_bytes."""
    raw = 8 * nb * Z + 4 * E * Z
    return raw + (-raw) % GMEM_STATE_ALIGN


def test_nr_bg1_z384_takes_the_device_memory_route():
    code = nrlike_code("1/2", 384)
    lay = code.layout
    assert (code.n, code.k, lay.E, lay.E * code.Z) == (17664, 8448, 193,
                                                       74112)
    assert code_flood_smem_bytes(code) == 510_832 > SMEM_LIMIT_BYTES
    assert flood_smem_bytes(384, 24, 46, 193, 0, True) == 362_608 \
        > SMEM_LIMIT_BYTES
    assert flood_gmem_state_bytes(384, 46, 193) == state_bytes(384, 46, 193) \
        == 437_760
    assert flood_gmem_state_bytes(384, 46, 193, True) == 289_536
    plan = flood_plan(code, coordinates(code, False)[0])
    assert plan.bucket == 0 and plan.threads == GENERIC_THREADS
    # the per-edge tables K1g keeps in shared memory, and vn_info's packing
    assert (24 + 1 + 3 * 193) * 4 == 2416
    assert lay.E * code.Z < 1 << VN_BASE_BITS


@pytest.mark.parametrize("bg,rate", CELLS, ids=[f"nr{b}-{r}" for b, r in CELLS])
def test_registry_cells_route_by_their_state_bytes(bg, rate):
    """At every NR lifting size each NR-like cell takes K1g exactly where
    its flooding state exceeds the limit, from FIRST_GMEM_Z on, and below
    keeps the shared-memory kernel in its bucket (the shapes at Z = 16
    scaled: the mask, hence E and the row degrees, does not depend on
    Z; checked on the real codes at both sides of the first Z)."""
    small = nrlike_code(rate, 16, bg=bg).layout
    mb, nb, E, deg = small.mb, small.nb, small.E, small.max_row_deg
    gmem = []
    for Z in NR_LIFTS:
        bucket = choose_bucket(deg, mb * Z, nb * Z, E * Z)
        smem = flood_smem_bytes(Z, mb, nb, E, bucket)
        if smem > SMEM_LIMIT_BYTES:
            gmem.append(Z)
            assert flood_gmem_state_bytes(Z, nb, E) == state_bytes(Z, nb, E)
    first = FIRST_GMEM_Z[(bg, rate)]
    assert gmem == [Z for Z in NR_LIFTS if first and Z >= first]
    for Z in ([NR_LIFTS[NR_LIFTS.index(first) - 1], first, 384] if first
              else [384]):
        code = nrlike_code(rate, Z, bg=bg)
        lay = code.layout
        assert (lay.mb, lay.nb, lay.E, lay.max_row_deg) == (mb, nb, E, deg)
        plan = flood_plan(code, coordinates(code, False)[0])
        assert plan.bucket == choose_bucket(deg, lay.m, lay.n, E * Z)
        assert (code_flood_smem_bytes(code) > SMEM_LIMIT_BYTES) == (
            first is not None and Z >= first)


def r_bytes(Z, E):
    """R alone (4 B a message), rounded up to GMEM_STATE_ALIGN."""
    raw = 4 * E * Z
    return raw + (-raw) % GMEM_STATE_ALIGN


def test_nr_bg1_z384_keeps_l_and_p_in_shared_memory():
    """Z = 384's placement: L, P and the row tables in 143,728 B of shared
    memory, R alone (296,448 B a codeword, 148,224 B in bf16) in the
    scratch, 1024 threads a block; with the limit below those bytes, the
    placement of L and P in the scratch."""
    assert 2 * 17664 * 4 + (24 + 1 + 3 * 193) * 4 == 143_728
    place = gmem_placement(384, 24, 46, 193)
    assert (place.shared_lp, place.threads, place.stride) == (
        True, GMEM_SHARED_LP_THREADS, 296_448)
    assert flood_gmem_smem_bytes(384, 24, 46, 193, True) == 143_728
    assert flood_gmem_smem_bytes(384, 24, 46, 193, False) == 2416
    assert GMEM_SHARED_LP_THREADS == 1024
    assert gmem_placement(384, 24, 46, 193, True).stride == 148_224
    assert r_bytes(384, 193) == 296_448 == 74112 * 4
    # 132 SMs' resident R fits the 50 MB L2
    assert 132 * place.stride < 50 * 2**20
    for limit in (0, 143_727):
        place = gmem_placement(384, 24, 46, 193, limit=limit)
        assert (place.shared_lp, place.threads, place.stride) == (
            False, GENERIC_THREADS, 437_760)
    assert gmem_placement(384, 24, 46, 193, limit=143_728).shared_lp


@pytest.mark.parametrize("bg,rate", CELLS, ids=[f"nr{b}-{r}" for b, r in CELLS])
def test_registry_cells_above_the_limit_keep_l_and_p_in_shared_memory(
        bg, rate):
    """Every NR-like cell that takes K1g at an NR lifting size keeps L and
    P in shared memory there, with R alone in the scratch, in float32
    and bf16 messages."""
    small = nrlike_code(rate, 16, bg=bg).layout
    mb, nb, E = small.mb, small.nb, small.E
    first = FIRST_GMEM_Z[(bg, rate)]
    for Z in (Z for Z in NR_LIFTS if first and Z >= first):
        smem = 8 * nb * Z + 4 * (mb + 1 + 3 * E)
        assert smem == flood_gmem_smem_bytes(Z, mb, nb, E, True)
        assert smem <= SMEM_LIMIT_BYTES
        for bf16 in (False, True):
            place = gmem_placement(Z, mb, nb, E, bf16)
            assert (place.shared_lp, place.threads) == (
                True, GMEM_SHARED_LP_THREADS)
            assert place.stride == flood_gmem_state_bytes(
                Z, nb, E, bf16, shared_lp=True)
            assert place.stride == (r_bytes(Z, E) if not bf16 else
                                    -(-2 * E * Z // GMEM_STATE_ALIGN)
                                    * GMEM_STATE_ALIGN)


@pytest.mark.parametrize("nb,E,shared_lp", [
    (68, 316, True),   # NR BG1's full 68 columns at Z = 384
    (74, 316, True),   # the widest that fits beside these row tables
    (75, 316, False),  # one block-column more
    (90, 400, False)])
def test_placement_follows_the_bytes_of_l_and_p(nb, E, shared_lp):
    """Z = 384, 46 block-rows: L and P stay in shared memory exactly while
    they and the row tables fit SMEM_LIMIT_BYTES; beyond, they take the
    scratch (L, P and R: 8n + 4EZ bytes a codeword) on GENERIC_THREADS."""
    Z, mb = 384, 46
    place = gmem_placement(Z, mb, nb, E)
    tables = 4 * (mb + 1 + 3 * E)
    assert (8 * nb * Z + tables <= SMEM_LIMIT_BYTES) == shared_lp
    assert place.shared_lp == shared_lp
    if shared_lp:
        assert (place.threads, place.stride) == (
            GMEM_SHARED_LP_THREADS, r_bytes(Z, E))
    else:
        assert (place.threads, place.stride) == (
            GENERIC_THREADS, state_bytes(Z, nb, E))
    assert flood_gmem_smem_bytes(Z, mb, nb, E, shared_lp) == (
        8 * nb * Z + tables if shared_lp else tables)


def test_cells_within_the_limit_keep_the_shared_memory_kernel():
    """The benchmark's codes and the registry's largest WiFi / WiMAX cells
    stay under the limit, in the buckets they had."""
    for code, bucket in ((LdpcCode.judged(), 8), (nrlike_code("1/2", 64), 0),
                         (LdpcCode.from_family("wimax", "1/2", 96), 0),
                         (LdpcCode.from_family("wifi", "5/6", 81), 32),
                         (nrlike_code("5/6", 288), 0)):
        assert code_flood_smem_bytes(code) <= SMEM_LIMIT_BYTES, code.name
        plan = flood_plan(code, coordinates(code, False)[0])
        assert plan.bucket == bucket


def wide_row(deg):
    """Two block-rows at Z = 5, the first of `deg` slots."""
    B = np.full((2, deg), -1)
    B[0, :] = np.arange(deg) % 5
    B[1, :4] = [1, 2, 3, 4]
    return LdpcCode.from_base_graph(B, 5, f"deg{deg}")


@pytest.fixture(scope="module")
def z384():
    return nrlike_code("1/2", 384)


# (code, algo, K1g, one gather): bucket 0's rows (K1 bucket 0, or K1g
# whatever the bucket) of at most SIGN_SLOTS slots, any CN update but
# exact sum-product
ONE_GATHER = [
    ("nr1-z64", "minsum", False, True),
    ("nr1-z64", "sumproduct-fast", False, True),
    ("nr1-z64", "sumproduct", False, False),
    ("nr1-z384", "minsum", True, True),
    ("nr1-z384", "sumproduct-fast", True, True),
    ("nr1-z384", "sumproduct", True, False),
    ("judged", "minsum", False, False),           # bucket 8, one pass
    ("judged", "sumproduct-fast", False, False),
    ("judged", "minsum", True, True),             # forced onto K1g
    ("deg32", "minsum", False, False),            # bucket 32, one pass
    ("deg32", "minsum", True, True),
    ("deg33", "minsum", False, False),
    ("deg33", "sumproduct-fast", True, False),
]


@pytest.mark.parametrize("key,algo,gmem,want", ONE_GATHER,
                         ids=[f"{k}-{a}-{'k1g' if g else 'k1'}"
                              for k, a, g, _ in ONE_GATHER])
def test_one_gather_follows_the_rows_and_the_cn_update(z384, key, algo,
                                                        gmem, want):
    """The launch's form, as the counter <name>_one_gather reports it:
    from the plan's largest row and the CN update alone."""
    code = {"nr1-z64": lambda: nrlike_code("1/2", 64), "nr1-z384": lambda:
            z384, "judged": LdpcCode.judged, "deg32": lambda: wide_row(32),
            "deg33": lambda: wide_row(33)}[key]()
    plan = flood_plan(code, coordinates(code, False)[0])
    assert plan.bucket == {"judged": 8, "deg32": 32}.get(key, 0)
    assert one_gather(plan, algo, gmem) == want


def test_sign_slots_is_the_kernels_register_width():
    """SIGN_SLOTS is csrc/bp_flood.cu's kSignSlots, the bits of the one
    register that holds a row's signs."""
    import pathlib
    import re

    import tpu_ldpc_torch

    src = (pathlib.Path(tpu_ldpc_torch.__file__).parent / "csrc"
           / "bp_flood.cu").read_text()
    assert re.findall(r"constexpr int kSignSlots = (\d+);", src) == [
        str(SIGN_SLOTS)] == ["32"]
    assert "uint32_t negs" in src


# ---- K1g's order of operations in torch ops -------------------------------


def punctured_llrs(code, batch=48, ebn0_db=1.0, seed=9):
    """The all-zero codeword through AWGN at the on-air rate, the two
    punctured block-columns as +0.0, and rows with -0.0 entries."""
    adapt = nrlike_adapt(code)
    rate = adapt.rate(code.n, code.k)
    sigma2 = 1.0 / (2 * rate * 10 ** (ebn0_db / 10))
    rng = np.random.default_rng(seed)
    y = 1.0 + np.sqrt(sigma2) * rng.normal(size=(batch, code.n))
    llr = (2.0 / sigma2 * y).astype(np.float32)
    llr[:, :2 * code.Z] = 0.0
    llr[0, 2 * code.Z::7] = -0.0
    llr[1, ::3] = -0.0
    llr[2, 2 * code.Z::5] = 0.0
    return torch.from_numpy(llr)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
def test_gmem_order_matches_plain_decoder_and_golden(algo, early_stop):
    """K1g runs bucket 0's two passes whatever the code's bucket:
    test_torch_flood_tables' torch-op decoder on that path, reading only
    the plan's tables, is its order of operations."""
    code = nrlike_code("1/2", 16)
    shifts, col_off = coordinates(code, False)
    plan = flood_plan(code, shifts)
    llr = punctured_llrs(code)
    assert (llr == 0).sum() > 0 and torch.signbit(llr[1, 0])
    iters = 12
    P, ok, iu = table_decoder(code, plan, "two-pass", col_off, iters,
                              early_stop, algo)(llr)
    wP, wok, wiu = build_decoder(code, algo, iters, ALPHA, 0.0, "flooding",
                                 early_stop).posterior(llr)
    assert torch.equal(P.view(torch.int32),
                       wP.reshape(len(llr), -1).view(torch.int32))
    assert torch.equal(ok, wok) and torch.equal(iu, wiu)
    gbits, gok, giu = golden_decode(code.H, llr.numpy(), algo=algo,
                                    iters=iters, alpha=ALPHA,
                                    dtype=np.float32, early_stop=early_stop)
    np.testing.assert_array_equal((P < 0).numpy().astype(np.uint8), gbits)
    np.testing.assert_array_equal(ok.numpy(), gok)
    np.testing.assert_array_equal(iu.numpy(), giu)
    assert 0 < int(ok.sum()) < len(llr)  # some frames fail, some pass


# ---- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (torch.cuda.is_available() is False): "
                    "the nvcc-built sm_90a kernels need an NVIDIA H100 and "
                    "the CUDA toolkit")
    return torch.device("cuda")


def noisy(code, batch, ebn0_db, seed, device, punct=0):
    """All-zero codewords through AWGN at the on-air rate (`punct`
    block-columns punctured, as +0.0), a row with -0.0 and one with
    1e4 entries."""
    g = torch.Generator().manual_seed(seed)
    rate = code.k / (code.n - punct * code.Z)
    sigma2 = 1.0 / (2 * rate * 10 ** (ebn0_db / 10))
    y = 1.0 + sigma2 ** 0.5 * torch.randn((batch, code.n), generator=g)
    llr = (2.0 / sigma2 * y).float()
    llr[:, :punct * code.Z] = 0.0
    llr[1, ::3] = -0.0
    llr[2, ::5] = 1e4
    return llr.to(device)


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        assert torch.equal(g.cpu(), w.cpu()), name


def deg40():
    """A row of degree 40, above the largest bucket."""
    B = np.full((2, 40), -1)
    B[0, :] = np.arange(40) % 5
    B[1, :4] = [1, 2, 3, 4]
    return LdpcCode.from_base_graph(B, 5, "deg40")


FORCED = {"judged": LdpcCode.judged,
          "wimax-1/2-96": lambda: LdpcCode.from_family("wimax", "1/2", 96),
          "nr1-1/2-16": lambda: nrlike_code("1/2", 16), "deg40": deg40}
MODES = {
    "minsum": dict(algo="minsum"),
    "minsum-normalized": dict(algo="minsum", normalize=True),
    "sumproduct-fast": dict(algo="sumproduct-fast"),
    "sumproduct": dict(algo="sumproduct"),
    "minsum-bf16": dict(algo="minsum", msg_dtype=torch.bfloat16),
    "sumproduct-fast-bf16": dict(algo="sumproduct-fast",
                                 msg_dtype=torch.bfloat16),
    "minsum-quant": dict(algo="minsum", quant_bits=6, quant_step=0.25),
    "minsum-rescaled": dict(algo="minsum", rescaled=True),
}


PLACEMENTS = ("shared-lp", "scratch-lp")


def force_gmem(monkeypatch, code, placement):
    """Lowers the limit so that `code` takes K1g in `placement`: to the
    bytes of its L, P and row tables (below the shared-memory kernel's
    state, which adds R) for L and P in shared memory, to 0 for L and P
    in the scratch."""
    lay = code.layout
    limit = (flood_gmem_smem_bytes(code.Z, lay.mb, lay.nb, lay.E, True)
             if placement == "shared-lp" else 0)
    assert limit < code_flood_smem_bytes(code)
    monkeypatch.setattr(cuda_bp, "SMEM_LIMIT_BYTES", limit)


def gmem_launches(kernel):
    return tuple(cuda_bp.LAUNCHES[f"{kernel}{suffix}"]
                 for suffix in ("_gmem", "_gmem_smem", "_one_gather"))


@pytest.mark.cuda
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("key", sorted(FORCED))
def test_gmem_kernel_on_codes_forced_onto_it(cuda, monkeypatch, key, mode,
                                             early_stop, placement):
    """With the limit lowered every code takes K1g, in either placement of
    L and P: it equals the shared-memory kernel bit for bit in every mode,
    and the plain decoder in every mode but exact sum-product (tanhf /
    logf).  K1g's rows send from the first pass's signs (and count
    <name>_one_gather) but for the row of 40 slots and exact sum-product,
    which recompute q; the shared-memory kernel's only in bucket 0."""
    code = FORCED[key]()
    kw = dict(normalize=False)
    kw.update(MODES[mode])
    algo = kw.pop("algo")
    fn = build_cuda_decoder_for(code, algo, early_stop, kw)
    llr = noisy(code, 200, 1.5, 3, cuda, 2 if key.startswith("nr") else 0)
    one_gather = key != "deg40" and algo != "sumproduct"
    bucket = flood_plan(code, coordinates(code, False)[0]).bucket
    gmem, smem, og = gmem_launches(fn.kernel)
    want = fn(llr)
    assert gmem_launches(fn.kernel) == (
        gmem, smem, og + (one_gather and bucket == 0))
    gmem, smem, og = gmem_launches(fn.kernel)
    force_gmem(monkeypatch, code, placement)
    got = fn(llr)
    assert gmem_launches(fn.kernel) == (
        gmem + 1, smem + (placement == "shared-lp"), og + one_gather)
    assert_same(got, want)
    if algo != "sumproduct":
        assert_same(got, build_decoder(code, algo, 30, ALPHA, 0.0,
                                       "flooding", early_stop, **kw)(llr))


def build_cuda_decoder_for(code, algo, early_stop, kw):
    return cuda_bp.build_cuda_decoder(code, algo, 30, ALPHA, 0.0, "flooding",
                                      early_stop, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
def test_gmem_kernel_z384_equals_plain(cuda, monkeypatch, z384, algo,
                                       early_stop, placement):
    """Z = 384 in its own placement (L and P in shared memory) and with
    the limit at 0 (L and P in the scratch)."""
    llr = noisy(z384, 64, 1.2, 5, cuda, 2)
    fn = cuda_bp.build_cuda_decoder(z384, algo, 50, ALPHA, 0.0, "flooding",
                                    early_stop, normalize=False)
    if placement == "scratch-lp":
        monkeypatch.setattr(cuda_bp, "SMEM_LIMIT_BYTES", 0)
    gmem, smem, og = gmem_launches(fn.kernel)
    got = fn(llr)
    assert gmem_launches(fn.kernel) == (
        gmem + 1, smem + (placement == "shared-lp"), og + 1)
    assert_same(got, build_decoder(z384, algo, 50, ALPHA, 0.0, "flooding",
                                   early_stop)(llr))
    assert 0 < int(got[1].sum())


@pytest.mark.cuda
def test_decode_and_mc_step_take_the_gmem_kernel(cuda, z384):
    """decode() and the MC step (nrlike_adapt) launch K1g on Z = 384, no
    torch-op decoder; the step's counters equal the same step decoding
    with the plain decoder on the card."""
    from tpu_ldpc_torch.decode import decode
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    llr = noisy(z384, 16, 1.2, 7, cuda, 2)
    gmem, smem, og = gmem_launches("minsum_flood")
    bits, ok, iu = decode(z384, llr)
    assert gmem_launches("minsum_flood") == (gmem + 1, smem + 1, og + 1)
    assert bits.device.type == "cuda"
    adapt = nrlike_adapt(z384)
    step = build_mc_step(z384, DecodeCfg(), 64, 2, adapt, device=cuda)
    gmem, smem, og = gmem_launches("minsum_flood")
    got = step(2**31 + 3, 0, 1.2, 0).tolist()
    # every K1g launch of the step keeps L and P in shared memory and
    # sends from the signs
    assert gmem_launches("minsum_flood") == (gmem + 2, smem + 2, og + 2)
    plain = build_mc_step(z384, DecodeCfg(impl="torch"), 64, 2, adapt,
                          device=cuda)
    assert got == plain(2**31 + 3, 0, 1.2, 0).tolist()
    assert got[0] == 128


@pytest.mark.cuda
def test_mc_batch_kernels_at_z384(cuda, z384):
    """Kernels A and B at Z = 384 (k = 8448: A's 264 x 9216-word table)
    against BatchFn's plain versions: LLRs as int32, the counters
    exactly."""
    from tpu_ldpc_torch.sim.mc import BatchFn, DecodeCfg, batch_generator

    fn = BatchFn(z384, DecodeCfg(), 64, cuda, nrlike_adapt(z384), None)
    assert fn.kernels is not None
    for seed, ebn0 in ((2**31 + 1, 1.0), (5, 1.2)):
        u, noise = fn.draw(batch_generator(seed, 0, 0, cuda))
        um, want_llr = fn.plain_llrs(u, noise, ebn0)
        llr = fn.kernels.encode_llr(u, noise, ebn0, fn.rate)
        assert torch.equal(llr.view(torch.int32), want_llr.view(torch.int32))
        bits, ok, iu = fn.decode_fn(llr)
        want = fn.plain_counters(um, bits, ok, iu)
        assert torch.equal(fn.batch_counters(u, noise, ebn0), want)


@pytest.mark.cuda
def test_gmem_span_in_a_profiled_decode(cuda, z384):
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    fn = build_decode_fn(z384, DecodeCfg(), cuda)
    llr = noisy(z384, 8, 1.2, 11, cuda, 2)
    fn(llr)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(llr)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "ldpc.decode" in names and "ldpc.decode.gmem" in names
    assert any("bp_flood_gmem_kernel" in n for n in names)
    assert not any("bp_flood_kernel" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("key,kw,limit", [
    ("z384", dict(schedule="layered"), None),
    ("judged", dict(schedule="layered"), 0),
    ("judged", dict(compressed=True), 0)])
def test_other_schedules_refuse_naming_flooding(cuda, monkeypatch, z384,
                                                key, kw, limit):
    """Above the limit (Z = 384's layered state, or any code with the limit
    at 0) the layered and compressed decoders still raise, naming the
    flooding schedule, which takes the code."""
    code = z384 if key == "z384" else LdpcCode.judged()
    fn = cuda_bp.build_cuda_decoder(code, "minsum", 5, **kw)
    if limit is not None:
        monkeypatch.setattr(cuda_bp, "SMEM_LIMIT_BYTES", limit)
    with pytest.raises(ValueError, match="schedule='flooding'"):
        fn(noisy(code, 4, 1.2, 13, cuda, 2 if key == "z384" else 0))


@pytest.mark.cuda
def test_gmem_entry_refuses_bad_arguments(cuda, z384):
    """ldpc_bp_flood_gmem refuses a missing or misaligned scratch, a stride
    below a codeword's state (L, P and R, or R alone with L and P in
    shared memory) or not a multiple of 16, a thread count that is not a
    positive multiple of 32 within the placement's bound, and the mode
    combinations ldpc_bp_flood refuses, launching nothing.  Its shared
    memory is the plan's."""
    from tpu_ldpc_torch._build import load_library

    lib = load_library("bp_flood")
    code = LdpcCode.judged()
    lay = code.layout
    for shared_lp in (0, 1):
        assert lib.ldpc_bp_flood_gmem_smem_bytes(
            code.Z, code.mb, code.nb, lay.E, shared_lp) == \
            flood_gmem_smem_bytes(code.Z, code.mb, code.nb, lay.E, shared_lp)
    plan = flood_plan(code, coordinates(code, False)[0])
    tabs = [torch.from_numpy(np.array(x)).to(cuda)
            for x in plan.tables().values()]
    llr = torch.zeros((4, code.n), device=cuda)
    out = torch.empty((4, code.n), dtype=torch.uint8, device=cuda)
    ok = torch.empty(4, dtype=torch.bool, device=cuda)
    iu = torch.empty(4, dtype=torch.int32, device=cuda)
    stride = flood_gmem_state_bytes(code.Z, code.nb, lay.E)
    need = 8 * code.n + 4 * lay.E * code.Z  # L, P and R
    need_r = 4 * lay.E * code.Z             # R alone
    state = torch.empty(4 * stride + 16, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(algo, bf16, rescaled, quantized, step, ptr, stride=stride,
             shared_lp=0, threads=GENERIC_THREADS):
        return lib.ldpc_bp_flood_gmem(
            algo, llr.data_ptr(), out.data_ptr(), ok.data_ptr(),
            iu.data_ptr(), *[t.data_ptr() or None for t in tabs], None, 4,
            code.Z, code.mb, code.nb, lay.E, 5, 0.75, 0.0, 1, bf16,
            rescaled, 1.0 / 0.75, quantized, step, 31.0, 7.75, 31.75,
            shared_lp, threads, ptr, stride, stream)

    base = state.data_ptr()
    lp = dict(shared_lp=1, threads=GMEM_SHARED_LP_THREADS)
    for args, kw in (((0, 0, 0, 0, 0.25, None), {}),  # no scratch
                     ((0, 0, 0, 0, 0.25, base + 4), {}),  # misaligned
                     ((0, 0, 0, 0, 0.25, base, need - 16), {}),  # too small
                     ((0, 0, 0, 0, 0.25, base, need + 8), {}),  # stride % 16
                     ((0, 0, 0, 0, 0.25, base, need_r - 16), lp),  # below R
                     ((0, 0, 0, 0, 0.25, base), dict(threads=0)),
                     ((0, 0, 0, 0, 0.25, base), dict(threads=48)),
                     ((0, 0, 0, 0, 0.25, base), dict(threads=512)),  # > 256
                     ((0, 0, 0, 0, 0.25, base), dict(lp, threads=1056)),
                     ((2, 0, 0, 1, 0.25, base), {}),  # quantized spfast
                     ((0, 1, 1, 0, 0.25, base), {}),  # rescaled bf16
                     ((0, 0, 0, 1, 0.3, base), lp)):  # step not 2^k
        assert call(*args, **kw) != 0, (args, kw)
    assert need % 16 == 0 and need <= stride and need_r % 16 == 0
    assert call(0, 0, 0, 0, 0.25, base, need) == 0
    assert call(0, 0, 0, 0, 0.25, base) == 0
    assert call(0, 0, 0, 0, 0.25, base, need_r, **lp) == 0
    assert call(0, 0, 0, 0, 0.25, base, need_r, shared_lp=1, threads=32) == 0
    torch.cuda.synchronize()
