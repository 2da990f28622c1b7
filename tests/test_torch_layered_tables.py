"""The host-side inputs of the layered kernel (decode/layered_plan.py) and
of the compressed-state kernel (decode/flood_plan.py::compressed_plan),
on the CPU, before any card time is spent on them.

- A small layered decoder written in torch ops that reads only the
  layered plan's tables -- the per-check P indices of the one-pass
  kernel (p_idx), or the per-edge offsets and shifts of the two-pass
  form (e_p, e_shift), and row_ptr -- with R in the kernel's per-check
  layout (R[r, e], r_stride wide) and the batch cut into the kernel's
  blocks of `group` codewords (padding codewords fed NaN LLRs, done from
  the start), agrees bit for bit with the port's plain layered decoder
  (posterior, ok, iters_used) and with the JAX package's jnp layered
  reference (bits, ok, iters_used): min-sum and 6-bit fixed-point, ET on
  and off, plain and normalized coordinates, on the toy code, wifi 2/3
  Z=27, judged and wimax 5/6 Z=96.
- The bucket, block shape, strides and shared memory of all 24 registry
  cells and of codes past the buckets.
- A compressed-state decoder in torch ops over compressed_plan's tables
  alone (cn_p, cn_deg, vn_info, vn_check; the row state packed as the
  kernel packs it) agrees bit for bit with golden float32, with the
  Pallas kernel (compressed=True, interpret mode; LLRs without exact
  zeros, whose sign the Pallas kernel reads otherwise) and with the
  port's plain compressed decoder.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.decode.reference import build_decoder as jax_build_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes import base_graphs
from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
from tpu_ldpc_torch.decode.flood_plan import (
    COMPRESSED_SLOTS, VN_BASE_BITS, compressed_plan)
from tpu_ldpc_torch.decode.layered_plan import (
    BUCKETS, MAX_BLOCK_THREADS, SM_BLOCK_RESERVED, SM_MAX_BLOCKS,
    SM_MAX_THREADS, SM_SMEM_BYTES, SMEM_LIMIT_BYTES, layered_plan,
    smem_bytes)
from tpu_ldpc_torch.decode.normalize import coordinates
from tpu_ldpc_torch.decode.reference import build_decoder, make_quantizers

torch.set_num_threads(1)

REGISTRY = [(family, rate, Z)
            for family, lifts in sorted(base_graphs.FAMILY_LIFTS.items())
            for rate in sorted(base_graphs._RATE_SHAPES)
            for Z in lifts]
CODES = ["toy", "wifi-2/3-27", "judged", "wimax-5/6-96"]
ALPHA = 0.75
ITERS = 12
Q6 = {"quant_bits": 6, "quant_step": 0.25}


def make_code(key):
    """(the JAX package's code, its port twin)."""
    if key == "toy":
        ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7),
                                          8, "toy8")
    elif key == "judged":
        ref = JaxLdpcCode.judged()
    else:
        family, rate, Z = key.split("-")
        ref = JaxLdpcCode.from_family(family, rate, int(Z))
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def frame_llrs(ref, batch=18, ebn0_db=2.0, seed=5, specials=True):
    """Noisy codewords, then (specials) rows with +-0.0 and +-1e4."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, ref.k)).astype(np.uint8)
    c = golden_encode(ref.H, u)
    sigma2 = 1.0 / (2 * ref.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    llr = (2.0 / sigma2 * y).astype(np.float32)
    if specials:
        llr[0, :] = 5.0
        llr[0, ::7] = -0.0
        llr[1, ::3] = -0.0
        llr[2, ::5] = 1e4
        llr[3, 1::9] = -1e4
        llr[3, ::4] = 0.0
    return llr


def state_index(code, col_off):
    """Decoder state index of each code variable v = j*Z + z: j*Z + (z -
    c_j) mod Z (the kernel's LLR load and bit store)."""
    Z = code.Z
    v = np.arange(code.n)
    j = v // Z
    return torch.from_numpy(j * Z + (v % Z - np.asarray(col_off)[j]) % Z)


def minsum_scan(qs, alpha, beta=0.0):
    """Golden's sequential two-min scan over one row's (batch, Z) q in edge
    order: first-occurrence argmin (strict <), a degree-1 row sending its
    own magnitude; returns the row's messages."""
    mags = [q.abs() for q in qs]
    min1 = mags[0]
    min2 = torch.full_like(min1, float("inf"))
    argmin = torch.zeros_like(min1, dtype=torch.int64)
    neg = qs[0] < 0
    for t in range(1, len(qs)):
        new = mags[t] < min1
        min2 = torch.where(new, min1, torch.minimum(min2, mags[t]))
        argmin = torch.where(new, t, argmin)
        min1 = torch.where(new, mags[t], min1)
        neg = neg ^ (qs[t] < 0)
    if len(qs) == 1:
        min2 = min1
    total = torch.where(neg, -1.0, 1.0)
    return [(total * torch.where(q < 0, -1.0, 1.0)) * (alpha * torch.clamp_min(
        torch.where(argmin == t, min2, min1) - beta, 0.0))
        for t, q in enumerate(qs)]


def layered_table_decoder(code, plan, path, col_off, iters, early_stop,
                          quant=None):
    """Layered min-sum in torch ops over the plan's tables alone: llr ->
    (posterior in the code's coordinates (batch, n), ok, iters_used)."""
    Z, n, E = code.Z, code.n, code.layout.E
    rows = plan.row_ptr.astype(np.int64)
    r = torch.arange(Z)
    if path == "table":
        idx = torch.from_numpy(plan.p_idx.astype(np.int64))
        cols = [idx[:, e] for e in range(E)]
    else:  # the two-pass form: P index = col_e * Z + (r + s_e) mod Z
        cols = [int(plan.e_p[e]) + (r + int(plan.e_shift[e])) % Z
                for e in range(E)]
    state = state_index(code, col_off)
    alpha = float(np.float32(ALPHA))
    if quant is None:
        qz = sat_msg = sat_post = (lambda x: x)
    else:
        qz, sat_msg, sat_post = make_quantizers(quant["quant_bits"],
                                                quant["quant_step"])

    def violated(P):
        bad = torch.zeros(P.shape[0], dtype=torch.bool)
        for i in range(len(rows) - 1):
            parity = torch.zeros(P.shape[0], Z, dtype=torch.bool)
            for e in range(rows[i], rows[i + 1]):
                parity ^= P[:, cols[e]] < 0
            bad |= parity.any(dim=1)
        return bad

    def sweep(P, R):
        P, R = P.clone(), R.clone()
        for i in range(len(rows) - 1):
            es = range(rows[i], rows[i + 1])
            q = [P[:, cols[e]] - R[:, :, e] for e in es]
            outs = [qz(o) for o in minsum_scan([sat_msg(x) for x in q],
                                               alpha)]
            for e, qe, out in zip(es, q, outs):
                P[:, cols[e]] = sat_post(qe + out)  # the unsaturated q
                R[:, :, e] = out
        return P, R

    def decode(llr):
        batch = llr.shape[0]
        G = plan.group
        total = -(-batch // G) * G
        present = torch.arange(total) < batch
        llr_blocks = torch.full((total, n), float("nan"))  # padding: NaN
        llr_blocks[:batch] = llr
        P = torch.empty(total, n)
        P[:, state] = qz(llr_blocks)
        R = torch.zeros(total, Z, plan.r_stride)
        converged = torch.zeros(total, dtype=torch.bool)
        iu = torch.full((total,), iters, dtype=torch.int32)
        if early_stop:
            converged = present & ~violated(P)
            iu = torch.where(converged, 0, iu)
        for it in range(1, iters + 1):
            live = present & ~converged
            if not live.view(-1, G).any(dim=1).any():
                break  # every block done
            P_new, R_new = sweep(P, R)
            P = torch.where(live[:, None], P_new, P)
            R = torch.where(live[:, None, None], R_new, R)
            if early_stop:
                now = live & ~violated(P)
                converged |= now
                iu = torch.where(now, it, iu)
        ok = converged if early_stop else ~violated(P)
        return P[:batch][:, state], ok[:batch], iu[:batch]

    return decode


@functools.lru_cache(maxsize=None)
def jax_layered(key, quant, early_stop):
    """The JAX package's jnp layered reference on the test LLRs."""
    ref, _ = make_code(key)
    fn = jax_build_decoder(ref, "minsum", ITERS, ALPHA, 0.0, "layered",
                           early_stop, **dict(quant))
    return [np.asarray(x) for x in fn(frame_llrs(ref))]


@pytest.mark.parametrize("path", ["table", "two-pass"])
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("quant", [None, Q6], ids=["f32", "q6"])
@pytest.mark.parametrize("key", CODES)
def test_layered_table_decoder_matches_plain_and_jax(key, quant, normalize,
                                                     early_stop, path):
    ref, code = make_code(key)
    shifts, col_off = coordinates(code, normalize)
    plan = layered_plan(code, shifts, 4, early_stop)
    if path == "table":
        assert plan.bucket in BUCKETS
    llr_np = frame_llrs(ref)
    llr = torch.from_numpy(llr_np)
    q = quant or {}
    got = layered_table_decoder(code, plan, path, col_off, ITERS,
                                early_stop, quant)(llr)
    P, ok, iu = build_decoder(code, "minsum", ITERS, ALPHA, 0.0, "layered",
                              early_stop, normalize=normalize,
                              **q).posterior(llr)
    # the posterior itself, bit for bit: a message off by one rounding
    # shows here before it shows in the bits
    np.testing.assert_array_equal(
        got[0].numpy().view(np.int32),
        P.reshape(len(llr), -1).numpy().view(np.int32), "posterior")
    assert torch.equal(got[1], ok) and torch.equal(got[2], iu)
    bits, jok, jiu = jax_layered(key, tuple(sorted(q.items())), early_stop)
    np.testing.assert_array_equal((got[0] < 0).numpy().astype(np.uint8),
                                  bits, "bits vs jnp")
    np.testing.assert_array_equal(got[1].numpy(), jok, "ok vs jnp")
    np.testing.assert_array_equal(got[2].numpy(), jiu, "iters_used vs jnp")
    assert 0 < int(ok.sum()) < len(llr)  # some frames fail, some pass


def banks_distinct(stride, itemsize):
    """The 32 checks of a warp reading the same edge hit 32 banks."""
    return len({(r * stride * itemsize // 4) % 32 for r in range(32)}) == 32


def resident(code, plan, group, msg_bytes=4):
    """Codewords of one SM at `group` codewords a block."""
    lay = code.layout
    nbytes = smem_bytes(lay.Z, lay.mb, lay.nb, lay.E, plan.bucket, group,
                        plan.idx_stride, plan.r_stride, msg_bytes)
    threads = -(-group * plan.cw_threads // 32) * 32
    if nbytes > SMEM_LIMIT_BYTES:
        return 0
    return group * min(SM_SMEM_BYTES // (nbytes + SM_BLOCK_RESERVED),
                       SM_MAX_THREADS // threads, SM_MAX_BLOCKS)


def check_plan(code, plan, msg_bytes=4, early_stop=False):
    lay = code.layout
    Z = lay.Z
    assert plan.cw_threads == min(Z, MAX_BLOCK_THREADS)
    assert plan.threads % 32 == 0
    assert plan.group * plan.cw_threads <= plan.threads
    assert plan.threads - plan.group * plan.cw_threads < 32
    assert plan.threads <= MAX_BLOCK_THREADS
    assert plan.smem == smem_bytes(Z, lay.mb, lay.nb, lay.E, plan.bucket,
                                   plan.group, plan.idx_stride,
                                   plan.r_stride, msg_bytes)
    assert plan.smem <= SMEM_LIMIT_BYTES
    # ET off: the group packs the most codewords on an SM, the fewest a
    # block; ET on: the fewest codewords that fill a warp, no more
    most, best = 0, 0
    g = 1
    while -(-g * plan.cw_threads // 32) * 32 <= MAX_BLOCK_THREADS or g == 1:
        res = resident(code, plan, g, msg_bytes)
        if res > best:
            most, best = g, res
        g += 1
    if early_stop:
        assert plan.group == min(most, max(1, 32 // plan.cw_threads))
    else:
        assert plan.group == most
    assert plan.r_stride >= lay.E and plan.idx_stride >= lay.E
    if Z >= 32:
        assert banks_distinct(plan.r_stride, msg_bytes)
        assert banks_distinct(plan.idx_stride, 2)
    if plan.bucket:
        assert lay.max_row_deg <= plan.bucket
        assert plan.bucket == min(b for b in BUCKETS
                                  if lay.max_row_deg <= b)
        assert plan.p_idx.shape == (Z, plan.idx_stride)
        assert plan.p_idx.dtype == np.uint16
        r = np.arange(Z)
        for e in range(lay.E):
            want = (int(lay.edge_col[e]) * Z
                    + (r + int(lay.edge_shift[e])) % Z)
            np.testing.assert_array_equal(plan.p_idx[:, e], want)
    else:
        assert plan.p_idx.size == 0


@pytest.mark.parametrize("family,rate,Z", REGISTRY,
                         ids=[f"{f}-{r}-{z}" for f, r, z in REGISTRY])
def test_layered_plan_on_registry(family, rate, Z):
    """Every registry cell runs a one-pass bucket (rows up to 20); float32
    and bf16 messages; and compressed state refuses its rows (9 and
    more)."""
    code = LdpcCode.from_family(family, rate, Z)
    shifts = tuple(int(s) for s in code.layout.edge_shift)
    for msg_bytes in (4, 2):
        for early_stop in (False, True):
            plan = layered_plan(code, shifts, msg_bytes, early_stop)
            assert plan.bucket in BUCKETS
            check_plan(code, plan, msg_bytes, early_stop)
    assert code.layout.max_row_deg > COMPRESSED_SLOTS
    with pytest.raises(ValueError, match="sign byte"):
        compressed_plan(code)


def test_layered_plan_edges():
    """The judged code: 8 slots, 4 codewords in 256 threads (ET on: one
    in 64); rows of 20, a row of 40 (ET on: 6 codewords of 5 checks in a
    warp), Z above the block cap, and SC chains whose index table no
    longer fits beside the state."""
    judged = LdpcCode.judged()
    shifts = coordinates(judged, False)[0]
    plan = layered_plan(judged, shifts)
    assert (plan.bucket, plan.group, plan.cw_threads, plan.threads) == (
        8, 4, 64, 256)
    assert (plan.idx_stride, plan.r_stride) == (54, 51)
    check_plan(judged, plan)
    plan = layered_plan(judged, shifts, 4, True)
    assert (plan.bucket, plan.group, plan.threads) == (8, 1, 64)
    check_plan(judged, plan, 4, True)
    B = np.full((2, 40), -1)
    B[0, :] = np.arange(40) % 5
    B[1, :4] = [1, 2, 3, 4]
    Bz = np.array([[0, 5, -1, 7, 1, -1], [3, -1, 2, 0, -1, 4],
                   [-1, 1, 6, -1, 0, 2]])
    for code, bucket in (
            (LdpcCode.from_family("wimax", "5/6", 48), 32),
            (LdpcCode.from_base_graph(B, 5, "deg40"), 0),
            (LdpcCode.from_base_graph(Bz, 300, "z300"), 0),
            (LdpcCode.from_base_graph(make_sc_base_graph(64, 64), 64,
                                      "sc_l64_z64"), 8),
            (LdpcCode.from_base_graph(make_sc_base_graph(64, 96), 96,
                                      "sc_l64_z96"), 0)):
        for early_stop in (False, True):
            plan = layered_plan(code, tuple(int(s) for s in
                                            code.layout.edge_shift), 4,
                                early_stop)
            assert plan.bucket == bucket, code.name
            check_plan(code, plan, 4, early_stop)
            if code.name == "deg40" and early_stop:
                assert (plan.group, plan.threads) == (6, 32)


def compressed_table_decoder(code, plan, iters, early_stop, alpha=ALPHA,
                             beta=0.0):
    """Flooding min-sum with compressed row state in torch ops over
    compressed_plan's tables alone: llr -> (posterior (batch, n), ok,
    iters_used).  The state of check c is (m1', m2', argmin | signs << 8),
    as the kernel packs it."""
    Z, m, n = code.Z, code.m, code.n
    cn_p = torch.from_numpy(plan.cn_p.astype(np.int64))
    deg = torch.from_numpy(plan.cn_deg.astype(np.int64))
    info = torch.from_numpy(plan.vn_info.view(np.uint32).astype(np.int64))
    vn_base = info & ((1 << VN_BASE_BITS) - 1)
    vn_deg = info >> VN_BASE_BITS
    vn_check = torch.from_numpy(plan.vn_check.astype(np.int64))
    checks = torch.arange(m)
    alpha = float(np.float32(alpha))
    beta = float(np.float32(beta))

    def message(state, c, slot):
        m1, m2, packed = (x[:, c] for x in state)
        mag = torch.where((packed & 0xff) == slot, m2, m1)
        return torch.where((packed >> (8 + slot)) & 1 == 1, -mag, mag)

    def violated(P):
        bad = torch.zeros(P.shape[0], m, dtype=torch.bool)
        for t in range(COMPRESSED_SLOTS):
            bad ^= (P[:, cn_p[t]] < 0) & (t < deg)
        return bad.any(dim=1)

    def cn_pass(P, state):
        q = [P[:, cn_p[t]] - message(state, checks, t)
             for t in range(COMPRESSED_SLOTS)]
        mags = [x.abs() for x in q]
        min1 = mags[0]
        min2 = torch.full_like(min1, float("inf"))
        argmin = torch.zeros(min1.shape, dtype=torch.int64)
        neg = (q[0] < 0).to(torch.int64)
        own = neg.clone()
        for t in range(1, COMPRESSED_SLOTS):
            valid = t < deg
            new = valid & (mags[t] < min1)
            min2 = torch.where(valid, torch.where(
                new, min1, torch.minimum(min2, mags[t])), min2)
            argmin = torch.where(new, t, argmin)
            min1 = torch.where(new, mags[t], min1)
            bit = (q[t] < 0).to(torch.int64) * valid
            neg = neg ^ bit
            own = own | (bit << t)
        min2 = torch.where(deg == 1, min1, min2)
        full = (1 << deg) - 1
        signs = torch.where(neg == 1, ~own & full, own)
        return (alpha * torch.clamp_min(min1 - beta, 0.0),
                alpha * torch.clamp_min(min2 - beta, 0.0),
                argmin | signs << 8)

    def vn_pass(L, state):
        P = L.clone()
        for t in range(int(vn_deg.max())):
            has = t < vn_deg
            w = vn_check[(vn_base + t * Z) * has]
            P = torch.where(has, P + message(state, w >> 3, w & 7), P)
        return P

    def decode(llr):
        batch = llr.shape[0]
        L = llr.clone()
        P = L.clone()
        state = (torch.zeros(batch, m), torch.zeros(batch, m),
                 torch.zeros(batch, m, dtype=torch.int64))
        done = torch.zeros(batch, dtype=torch.bool)
        iu = torch.full((batch,), iters, dtype=torch.int32)
        for it in range(1, iters + 1):
            if early_stop:
                # the CN pass's check of the pre-pass posterior P_{it-1}
                now = ~violated(P) & ~done
                iu = torch.where(now, it - 1, iu)
                done |= now
            new_state = cn_pass(P, state)
            P_new = vn_pass(L, new_state)
            P = torch.where(done[:, None], P, P_new)
            state = tuple(torch.where(done[:, None], old, new)
                          for old, new in zip(state, new_state))
        ok = done | ~violated(P)
        return P, ok, iu

    return decode


def assert_same(got, want, what):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("key", ["toy", "judged"])
def test_compressed_table_decoder_vs_golden_pallas_and_plain(key,
                                                            early_stop):
    ref, code = make_code(key)
    plan = compressed_plan(code)
    assert plan.one_check and plan.threads == -(-code.m // 32) * 32
    iters = 10 if key == "toy" else 15
    batch = 24 if key == "toy" else 8
    llr_np = frame_llrs(ref, batch=batch, ebn0_db=2.5, seed=9)
    decode = compressed_table_decoder(code, plan, iters, early_stop)
    P, ok, iu = decode(torch.from_numpy(llr_np))
    got = [(P < 0).numpy().astype(np.uint8), ok.numpy(), iu.numpy()]
    kw = dict(iters=iters, alpha=ALPHA, early_stop=early_stop)
    assert_same(got, golden_decode(ref.H, llr_np, algo="minsum",
                                   dtype=np.float32, **kw), "golden")
    Pp, okp, iup = build_decoder(code, "minsum", compressed=True,
                                 **kw).posterior(torch.from_numpy(llr_np))
    np.testing.assert_array_equal(
        P.numpy().view(np.int32),
        Pp.reshape(batch, -1).numpy().view(np.int32), "posterior")
    assert torch.equal(ok, okp) and torch.equal(iu, iup)
    if key == "toy":  # Pallas reads sign bits: LLRs without exact zeros
        clean = frame_llrs(ref, batch=batch, ebn0_db=2.5, seed=9,
                           specials=False)
        P, ok, iu = decode(torch.from_numpy(clean))
        pallas = build_pallas_decoder(ref, "minsum", compressed=True,
                                      interpret=True, **kw)
        assert_same([(P < 0).numpy().astype(np.uint8), ok.numpy(),
                     iu.numpy()], pallas(clean), "Pallas")
    assert 0 < int(ok.sum()) < batch


def test_compressed_plan_forms():
    """One check per thread up to 1024 checks whose tables fit; the
    walking form past that (SC chains), its state still in shared
    memory; the per-variable table lists each column's checks in
    ascending block-row order."""
    judged = LdpcCode.judged()
    plan = compressed_plan(judged)
    assert (plan.one_check, plan.threads, plan.smem) == (True, 512, 33536)
    lay = judged.layout
    Z = lay.Z
    info = plan.vn_info.view(np.uint32)
    for v in range(0, judged.n, 37):
        j, z = divmod(v, Z)
        base = int(info[v]) & ((1 << VN_BASE_BITS) - 1)
        got = [int(plan.vn_check[base + t * Z])
               for t in range(int(info[v]) >> VN_BASE_BITS)]
        want = []
        for e in lay.col_edges(j):
            i = int(lay.edge_row[e])
            check = i * Z + (z - int(lay.edge_shift[e])) % Z
            want.append(check << 3 | (e - int(lay.row_ptr[i])))
        assert got == want
    for L, Z, one_check in ((8, 64, True), (32, 64, False),
                            (64, 96, False)):
        code = LdpcCode.from_base_graph(make_sc_base_graph(L, Z), Z,
                                        f"sc_l{L}_z{Z}")
        plan = compressed_plan(code)
        assert plan.one_check == one_check, code.name
        assert plan.threads == (-(-code.m // 32) * 32 if one_check
                                else 256)
        assert plan.smem <= SMEM_LIMIT_BYTES
