"""The layered decoder's device-memory form, K2g (``bp_layered_gmem_kernel``
in ``csrc/bp_layered.cu``): the codes that take it and its placement on
the CPU, and (marked ``cuda``, skipped without a card) the kernel itself.

- The route: a layered decode whose K2 state (P and R of one codeword
  beside the tables) exceeds ``SMEM_LIMIT_BYTES`` takes K2g; NR BG2 r1/5
  and BG1 r1/2 at Z = 384 do, and so does every NR-like registry cell
  above the limit at the NR lifting sizes, in float32 messages.
- The placement (``layered_gmem_placement``): one codeword a block of
  one thread a check, P and bucket 0's per-edge tables in shared memory
  within the limit, R edge-major in a scratch of ``stride`` bytes a
  codeword.
- The launch counters ``<layered name>_gmem``.
- On the card: K2g against K2 and the plain decoder in every layered
  mode on codes forced onto the route, and on Z = 384 itself;
  ``decode()``, ``build_decode_fn`` and the MC step launching K2g; the
  span ``ldpc.decode.gmem``; the C entry's refusals.  On a machine with
  the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_layered_gmem.py -q
"""

import numpy as np
import pytest
import torch

from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes.nrlike import (
    M_BY_RATE, M_BY_RATE2, nrlike_adapt, nrlike_code)
from tpu_ldpc_torch.decode import cuda_bp
from tpu_ldpc_torch.decode.flood_plan import GMEM_STATE_ALIGN, SMEM_LIMIT_BYTES
from tpu_ldpc_torch.decode.layered_plan import (
    GMEM_MAX_THREADS, conflict_free_stride, gmem_smem_bytes,
    layered_gmem_placement, layered_plan)
from tpu_ldpc_torch.decode.normalize import coordinates
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)

# TS 38.212 Table 5.3.2-1: Z = a * 2^j, a in {2, 3, 5, 7, 9, 11, 13, 15}
NR_LIFTS = sorted({a << j for a in (2, 3, 5, 7, 9, 11, 13, 15)
                   for j in range(8) if a << j <= 384})
# the smallest NR lifting size at which each NR-like cell's layered state
# (float32 messages) outgrows one block's shared memory (None: never up to
# 384; in bf16 none does)
FIRST_GMEM_Z = {(1, "1/2"): 256, (1, "2/3"): 352, (1, "3/4"): None,
                (1, "5/6"): None, (2, "1/5"): 240, (2, "2/7"): 352,
                (2, "2/5"): None, (2, "1/2"): None, (2, "2/3"): None}
CELLS = [(1, rate) for rate in M_BY_RATE] + [(2, rate) for rate in M_BY_RATE2]
ALPHA = 0.75


def align16(x):
    return -(-x // 16) * 16


def k2_min_bytes(Z, mb, nb, E, msg_bytes=4):
    """The least shared memory K2 can hold a code in: bucket 0's per-edge
    tables, the row pointer, one codeword's P and R (its conflict-free
    check stride) and two flags, written out apart from the plan."""
    r_stride = E | 1 if msg_bytes == 4 else E + (2 - E) % 4
    return (align16(8 * E) + align16(4 * (mb + 1)) + align16(4 * nb * Z)
            + align16(msg_bytes * Z * r_stride) + 8)


def k2g_bytes(Z, mb, nb, E):
    """K2g's block: the same without R."""
    return align16(8 * E) + align16(4 * (mb + 1)) + align16(4 * nb * Z) + 8


def plan_of(code, msg_bytes=4):
    """K2's plan and K2g's placement of `code`."""
    lay = code.layout
    return (layered_plan(code, tuple(coordinates(code, False)[0]),
                         msg_bytes, True),
            layered_gmem_placement(code.Z, lay.mb, lay.nb, lay.E,
                                   msg_bytes))


@pytest.mark.parametrize("rate,bg,shape", [
    ("1/5", 2, (19968, 3840, 42, 52, 192, 11)),
    ("1/2", 1, (17664, 8448, 24, 46, 193, 20))])
def test_z384_takes_the_device_memory_route(rate, bg, shape):
    """BG2 r1/5 and BG1 r1/2 at Z = 384: K2's state (most of it R) exceeds
    the limit; K2g holds P and the tables in shared memory, one codeword
    a block of 384 threads, R edge-major in the scratch."""
    code = nrlike_code(rate, 384, 11, bg)
    lay = code.layout
    n, k, mb, nb, E, deg = shape
    assert (code.n, code.k, lay.mb, lay.nb, lay.E, lay.max_row_deg) == shape
    k2, k2g = plan_of(code)
    assert k2.smem == k2_min_bytes(384, mb, nb, E) > SMEM_LIMIT_BYTES
    assert (k2g.cw_threads, k2g.threads) == (384, 384)
    assert k2g.smem == gmem_smem_bytes(384, mb, nb, E) == k2g_bytes(
        384, mb, nb, E) <= SMEM_LIMIT_BYTES
    assert k2g.stride == 4 * E * 384 and k2g.stride % GMEM_STATE_ALIGN == 0
    # the per-edge tables K2g reads from K2's plan (bucket 0 there too)
    assert k2.bucket == 0 and k2.p_idx.size == 0
    np.testing.assert_array_equal(k2.e_p, np.asarray(lay.edge_col) * 384)
    np.testing.assert_array_equal(k2.row_ptr, lay.row_ptr)
    # blocks an SM by shared memory (233,472 B, 1 KB reserved a block)
    blocks = 233_472 // (k2g.smem + 1024)
    assert blocks == (2 if bg == 2 else 3)
    if bg == 2:
        assert k2.smem == 378_040 and k2g.smem == 81_592
        assert k2g.stride == 294_912
    # bf16 messages: R at 2 B a message, rounded to the alignment
    assert plan_of(code, 2)[1].stride == 2 * E * 384


@pytest.mark.parametrize("bg,rate", CELLS, ids=[f"nr{b}-{r}" for b, r in CELLS])
def test_registry_cells_route_by_their_layered_state(bg, rate):
    """At every NR lifting size each NR-like cell takes K2g exactly where
    K2 cannot hold one codeword, from FIRST_GMEM_Z on, and there K2g's P
    and tables fit one block (the shapes at Z = 16 scaled; checked on
    the real codes at Z = 384 and the first Z)."""
    small = nrlike_code(rate, 16, bg=bg).layout
    mb, nb, E = small.mb, small.nb, small.E
    first = FIRST_GMEM_Z[(bg, rate)]
    over = [Z for Z in NR_LIFTS if k2_min_bytes(Z, mb, nb, E)
            > SMEM_LIMIT_BYTES]
    assert over == [Z for Z in NR_LIFTS if first and Z >= first]
    for Z in over:
        assert k2g_bytes(Z, mb, nb, E) == gmem_smem_bytes(Z, mb, nb, E) \
            <= SMEM_LIMIT_BYTES
    # bf16 messages halve R: no cell needs K2g there
    assert all(k2_min_bytes(Z, mb, nb, E, 2) <= SMEM_LIMIT_BYTES
               for Z in NR_LIFTS)
    for Z in sorted({first or 384, 384}):
        code = nrlike_code(rate, Z, bg=bg)
        k2, k2g = plan_of(code)
        assert (k2.smem > SMEM_LIMIT_BYTES) == (first is not None)
        assert k2g.smem <= SMEM_LIMIT_BYTES and k2g.cw_threads == Z
        assert plan_of(code, 2)[0].smem <= SMEM_LIMIT_BYTES


def test_a_code_beyond_any_block_is_refused():
    """P alone beyond one block's shared memory: no layered form holds
    it."""
    assert k2g_bytes(2048, 2, 30, 60) > SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        layered_gmem_placement(2048, 2, 30, 60)
    # one thread a check up to 512 checks, whole warps
    assert GMEM_MAX_THREADS == 512
    assert layered_gmem_placement(600, 2, 30, 60).threads == 512
    assert layered_gmem_placement(300, 2, 30, 60).threads == 320


def test_layered_gmem_launch_counters():
    """Every layered kernel name has its _gmem counter, as the flooding
    names do; the compressed kernel has none."""
    layered = [n for n in cuda_bp.LAUNCHES
               if n.endswith("_layered") or n.endswith("_layered_bf16")]
    assert sorted(layered) == sorted([
        "minsum_layered", "minsum_layered_bf16", "sumproduct_layered",
        "sumproduct_layered_bf16", "spfast_layered", "spfast_layered_bf16",
        "minsum_quant_layered"])
    for name in layered:
        assert cuda_bp.LAUNCHES[f"{name}_gmem"] >= 0
    assert "minsum_compressed_flood_gmem" not in cuda_bp.LAUNCHES
    assert "minsum_layered_gmem_smem" not in cuda_bp.LAUNCHES
    assert conflict_free_stride(192, 4) == 193  # K2's R stride at BG2


# ---- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (torch.cuda.is_available() is False): "
                    "the nvcc-built sm_90a kernels need an NVIDIA H100 and "
                    "the CUDA toolkit")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def z384_codes():
    return {"nr2-z384": nrlike_code("1/5", 384, 11, 2),
            "nr1-z384": nrlike_code("1/2", 384)}


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
        assert torch.equal(g.cpu(), w.cpu().to(g.dtype)), name


def frame_agreement(got, want):
    same = ((got[0] == want[0].to(got[0].dtype)).all(dim=1)
            & (got[1] == want[1]) & (got[2] == want[2].to(got[2].dtype)))
    return same.float().mean().item()


def deg40():
    """A row of degree 40, above the largest bucket."""
    B = np.full((2, 40), -1)
    B[0, :] = np.arange(40) % 5
    B[1, :4] = [1, 2, 3, 4]
    return LdpcCode.from_base_graph(B, 5, "deg40")


FORCED = {"judged": LdpcCode.judged,
          "nr1-1/2-16": lambda: nrlike_code("1/2", 16),
          "nr2-1/5-16": lambda: nrlike_code("1/5", 16, 11, 2),
          "deg40": deg40}
MODES = {
    "minsum": dict(algo="minsum"),
    "minsum-normalized": dict(algo="minsum", normalize=True),
    "sumproduct-fast": dict(algo="sumproduct-fast"),
    "sumproduct": dict(algo="sumproduct"),
    "minsum-bf16": dict(algo="minsum", msg_dtype=torch.bfloat16),
    "sumproduct-fast-bf16": dict(algo="sumproduct-fast",
                                 msg_dtype=torch.bfloat16),
    "sumproduct-bf16": dict(algo="sumproduct", msg_dtype=torch.bfloat16),
    "minsum-quant": dict(algo="minsum", quant_bits=6, quant_step=0.25),
}


@pytest.mark.cuda
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("key", sorted(FORCED))
def test_gmem_kernel_on_codes_forced_onto_it(cuda, monkeypatch, key, mode,
                                             early_stop):
    """With the limit lowered every code takes K2g: it equals K2 bit for
    bit in every layered mode, and the plain decoder in every mode but
    exact sum-product (tanhf / logf), which agrees frame by frame."""
    code = FORCED[key]()
    kw = dict(normalize=False)
    kw.update(MODES[mode])
    algo = kw.pop("algo")
    fn = cuda_bp.build_cuda_decoder(code, algo, 30, ALPHA, 0.0, "layered",
                                    early_stop, **kw)
    llr = noisy(code, 200, 1.5, 3, cuda, 2 if key.startswith("nr") else 0)
    gmem = cuda_bp.LAUNCHES[f"{fn.kernel}_gmem"]
    want = fn(llr)
    assert cuda_bp.LAUNCHES[f"{fn.kernel}_gmem"] == gmem
    monkeypatch.setattr(cuda_bp, "SMEM_LIMIT_BYTES", 0)
    got = fn(llr)
    assert cuda_bp.LAUNCHES[f"{fn.kernel}_gmem"] == gmem + 1
    assert_same(got, want)
    plain = build_decoder(code, algo, 30, ALPHA, 0.0, "layered", early_stop,
                          **kw)(llr)
    if algo == "sumproduct":
        assert frame_agreement(got, plain) >= 0.99
    else:
        assert_same(got, plain)
    assert 0 < int(got[1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("key", ["nr2-z384", "nr1-z384"])
def test_gmem_kernel_z384_equals_plain(cuda, z384_codes, key, algo,
                                       early_stop):
    code = z384_codes[key]
    llr = noisy(code, 64, 1.0 if key == "nr2-z384" else 1.2, 5, cuda, 2)
    fn = cuda_bp.build_cuda_decoder(code, algo, 25, ALPHA, 0.0, "layered",
                                    early_stop, normalize=False)
    gmem = cuda_bp.LAUNCHES[f"{fn.kernel}_gmem"]
    got = fn(llr)
    assert cuda_bp.LAUNCHES[f"{fn.kernel}_gmem"] == gmem + 1
    assert_same(got, build_decoder(code, algo, 25, ALPHA, 0.0, "layered",
                                   early_stop)(llr))
    assert 0 < int(got[1].sum())


@pytest.mark.cuda
def test_decode_build_decode_fn_and_mc_step_take_the_gmem_kernel(
        cuda, z384_codes):
    """decode(), build_decode_fn and the MC step (nrlike_adapt) launch K2g
    on BG2 r1/5 at Z = 384; the step's counters equal the same step
    decoding with the plain decoder on the card."""
    from tpu_ldpc_torch.decode import decode
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    code = z384_codes["nr2-z384"]
    cfg = DecodeCfg(schedule="layered", iters=25)
    llr = noisy(code, 16, 1.0, 7, cuda, 2)
    gmem = cuda_bp.LAUNCHES["minsum_layered_gmem"]
    bits, ok, iu = decode(code, llr, schedule="layered", iters=25)
    assert bits.device.type == "cuda"
    want = build_decode_fn(code, cfg, cuda)(llr)
    assert cuda_bp.LAUNCHES["minsum_layered_gmem"] == gmem + 2
    assert_same((bits, ok, iu), want)
    adapt = nrlike_adapt(code)
    step = build_mc_step(code, cfg, 64, 2, adapt, device=cuda)
    gmem = cuda_bp.LAUNCHES["minsum_layered_gmem"]
    got = step(2**31 + 3, 0, 1.0, 0).tolist()
    assert cuda_bp.LAUNCHES["minsum_layered_gmem"] == gmem + 2
    plain = build_mc_step(code, DecodeCfg(schedule="layered", iters=25,
                                          impl="torch"), 64, 2, adapt,
                          device=cuda)
    assert got == plain(2**31 + 3, 0, 1.0, 0).tolist()
    assert got[0] == 128


@pytest.mark.cuda
def test_gmem_span_in_a_profiled_decode(cuda, z384_codes):
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    code = z384_codes["nr2-z384"]
    fn = build_decode_fn(code, DecodeCfg(schedule="layered", iters=25),
                         cuda)
    llr = noisy(code, 8, 1.0, 11, cuda, 2)
    fn(llr)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(llr)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "ldpc.decode" in names and "ldpc.decode.gmem" in names
    assert any("bp_layered_gmem_kernel" in n for n in names)
    assert not any("bp_layered_kernel" in n for n in names)


@pytest.mark.cuda
def test_gmem_entry_refuses_bad_arguments(cuda):
    """ldpc_bp_layered_gmem refuses a missing or misaligned scratch, a
    stride below a codeword's R or not a multiple of 16, a block shape
    the code does not fit, and the mode combinations ldpc_bp_layered
    refuses, launching nothing.  Its shared memory is the plan's."""
    from tpu_ldpc_torch._build import load_library

    lib = load_library("bp_layered")
    code = LdpcCode.judged()
    lay = code.layout
    assert lib.ldpc_bp_layered_gmem_smem_bytes(
        code.Z, code.mb, code.nb, lay.E) == gmem_smem_bytes(
            code.Z, code.mb, code.nb, lay.E)
    plan = layered_plan(code, tuple(coordinates(code, False)[0]))
    place = layered_gmem_placement(code.Z, code.mb, code.nb, lay.E)
    tabs = [torch.from_numpy(np.array(x)).to(cuda)
            for x in (plan.row_ptr, plan.e_p, plan.e_shift)]
    llr = torch.zeros((4, code.n), device=cuda)
    out = torch.empty((4, code.n), dtype=torch.uint8, device=cuda)
    ok = torch.empty(4, dtype=torch.bool, device=cuda)
    iu = torch.empty(4, dtype=torch.int32, device=cuda)
    need = 4 * lay.E * code.Z
    state = torch.empty(4 * place.stride + 16, dtype=torch.uint8,
                        device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    base = state.data_ptr()

    def call(algo=0, bf16=0, quantized=0, step=0.25, ptr=base,
             stride=place.stride, cw=64, threads=64):
        return lib.ldpc_bp_layered_gmem(
            algo, llr.data_ptr(), out.data_ptr(), ok.data_ptr(),
            iu.data_ptr(), *[t.data_ptr() for t in tabs], None, 4, code.Z,
            code.mb, code.nb, lay.E, cw, threads, 5, 0.75, 0.0, 1, bf16,
            quantized, step, 31.0, 7.75, 31.75, ptr, stride, stream)

    for kw in (dict(ptr=None), dict(ptr=base + 4),
               dict(stride=need - 16), dict(stride=need + 8),
               dict(threads=0), dict(threads=48), dict(threads=544, cw=64),
               dict(cw=65, threads=96), dict(cw=0), dict(cw=64, threads=32),
               dict(algo=2, quantized=1), dict(bf16=1, quantized=1),
               dict(quantized=1, step=0.3), dict(algo=3)):
        assert call(**kw) != 0, kw
    assert need % 16 == 0 and need <= place.stride
    assert call() == 0
    assert call(stride=need) == 0
    assert call(cw=32, threads=32) == 0  # two checks a thread
    assert call(bf16=1, stride=2 * lay.E * code.Z) == 0
    torch.cuda.synchronize()
