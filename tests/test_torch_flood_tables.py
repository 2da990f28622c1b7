"""The host-side inputs of the flooding kernel (decode/flood_plan.py), on
the CPU, before any card time is spent on them.

- A small decoder written in torch ops that reads only the plan's tables
  -- the per-check slot indices of the one-pass kernel (cn_p, cn_r,
  cn_deg), or the per-edge tables of the two-pass kernel (row_ptr, e_p,
  e_r, e_shift), and the per-variable R slots (vn_info) -- with R in the
  kernel's variable-aligned, column-grouped layout, agrees bit for bit
  with the plain decoder (reference.build_decoder, float32 min-sum and
  sumproduct-fast) on the posterior, ok and iters_used, in plain and
  normalized coordinates, ET on and off.
- The bucket (the kernel's compile-time row-degree bound) and block size
  of every registry cell and of rows above the largest bucket.
- Fixed-point's quantizer multiplies by the exact reciprocal of its
  power-of-two step instead of dividing: the same float32 for every
  input, over the steps 2^-10 .. 2^4.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes import base_graphs
from tpu_ldpc_torch.decode.flood_plan import (
    BUCKETS, MAX_THREADS, PACK_LIMIT, VN_BASE_BITS, choose_bucket,
    flood_plan)
from tpu_ldpc_torch.decode.normalize import coordinates
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)

REGISTRY = [(family, rate, Z)
            for family, lifts in sorted(base_graphs.FAMILY_LIFTS.items())
            for rate in sorted(base_graphs._RATE_SHAPES)
            for Z in lifts]
CODES = ["toy", "wifi-2/3-27", "judged", "wimax-5/6-96"]
ALPHA = 0.75


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


def frame_llrs(ref, batch=24, ebn0_db=2.0, seed=5):
    """Noisy codewords, then rows with +-0.0 and +-1e4 entries."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, ref.k)).astype(np.uint8)
    c = golden_encode(ref.H, u)
    sigma2 = 1.0 / (2 * ref.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    llr = (2.0 / sigma2 * y).astype(np.float32)
    llr[0, :] = 5.0
    llr[0, ::7] = -0.0
    llr[1, ::3] = -0.0
    llr[2, ::5] = 1e4
    llr[3, 1::9] = -1e4
    llr[3, ::4] = 0.0
    return torch.from_numpy(llr)


def slot_indices(plan, path, Z):
    """(P index, R index) of slot t of check c, both (slots, m), and the
    row degree of each check, as the kernel of `path` gets them: the
    one-pass kernel reads cn_p / cn_r / cn_deg; the two-pass kernel walks
    row_ptr and the per-edge tables, check c = i*Z + r at z = (r +
    e_shift) mod Z."""
    if path == "one-pass":
        return (torch.from_numpy(plan.cn_p.astype(np.int64)),
                torch.from_numpy(plan.cn_r.astype(np.int64)),
                torch.from_numpy(plan.cn_deg.astype(np.int64)))
    row_ptr = plan.row_ptr.astype(np.int64)
    mb = len(row_ptr) - 1
    deg = np.diff(row_ptr)
    slots = int(deg.max())
    cn_p = np.zeros((slots, mb * Z), np.int64)
    cn_r = np.zeros((slots, mb * Z), np.int64)
    r = np.arange(Z)
    for i in range(mb):
        for t, e in enumerate(range(row_ptr[i], row_ptr[i + 1])):
            z = (r + plan.e_shift[e]) % Z
            cn_p[t, i * Z:(i + 1) * Z] = plan.e_p[e] + z
            cn_r[t, i * Z:(i + 1) * Z] = plan.e_r[e] + z
    return (torch.from_numpy(cn_p), torch.from_numpy(cn_r),
            torch.from_numpy(np.repeat(deg, Z)))


def cn_magnitudes(algo, mags, valid, deg):
    """The magnitude each slot of a check sends, before its sign, as
    bp_common.cuh's CN update computes it: min-sum alpha * max(min - 0,
    0) over the two smallest; sumproduct-fast the pairwise soft-min of the
    three smallest (the two smallest alone below degree 3).  mags and
    valid: per slot, (batch, checks); deg: (checks,)."""
    slots = len(mags)
    inf = torch.full_like(mags[0], float("inf"))
    m1, m2, m3 = mags[0], inf, inf
    a1 = torch.zeros_like(m1, dtype=torch.int64)
    a2 = torch.full_like(a1, -1)
    for t in range(1, slots):
        x, v = mags[t], valid[t]
        lt1, lt2, lt3 = v & (x < m1), v & (x < m2), v & (x < m3)
        m3 = torch.where(lt1 | lt2, m2, torch.where(lt3, x, m3))
        m2 = torch.where(lt1, m1, torch.where(lt2, x, m2))
        a2 = torch.where(lt1, a1, torch.where(lt2, t, a2))
        m1 = torch.where(lt1, x, m1)
        a1 = torch.where(lt1, t, a1)
    if algo == "minsum":
        alpha = float(np.float32(ALPHA))
        m2 = torch.where(deg == 1, m1, m2)
        s1 = alpha * torch.clamp_min(m1 - 0.0, 0.0)
        s2 = alpha * torch.clamp_min(m2 - 0.0, 0.0)
        return [torch.where(a1 == t, s2, s1) for t in range(slots)]

    def ctilde(x):
        return torch.clamp_min(torch.maximum(torch.maximum(
            0.6931472 - 0.5 * x, 0.57 - 0.25 * x), 0.40 - 0.125 * x), 0.0)

    def fpair(a, b):
        return torch.clamp_min(torch.minimum(a, b) + (
            ctilde(a + b) - ctilde((a - b).abs())), 0.0)

    f23, f13, f12 = fpair(m2, m3), fpair(m1, m3), fpair(m1, m2)
    return [torch.where(deg == 1, m1, torch.where(
        deg == 2, torch.where(a1 == t, m2, m1), torch.where(
            a1 == t, f23, torch.where(a2 == t, f13, f12))))
        for t in range(slots)]


def table_decoder(code, plan, path, col_off, iters, early_stop,
                  algo="minsum"):
    """Flooding min-sum (or sumproduct-fast) in torch ops over the plan's
    tables alone: llr -> (posterior in the code's coordinates (batch, n),
    ok, iters_used)."""
    Z, n = code.Z, code.n
    cn_p, cn_r, deg = slot_indices(plan, path, Z)
    slots = cn_p.shape[0]
    info = torch.from_numpy(plan.vn_info.view(np.uint32).astype(np.int64))
    vn_base = info & ((1 << VN_BASE_BITS) - 1)
    vn_deg = info >> VN_BASE_BITS
    # state index of each code variable v = j*Z + z: j*Z + (z - c_j) mod Z
    v = np.arange(n)
    j = v // Z
    state = torch.from_numpy(
        j * Z + (v % Z - np.asarray(col_off)[j]) % Z)

    def syndrome_ok(P):
        bad = torch.zeros(P.shape[0], cn_p.shape[1], dtype=torch.bool)
        for t in range(slots):
            bad ^= (P[:, cn_p[t]] < 0) & (t < deg)
        return ~bad.any(dim=1)

    def iteration(L, P, R):
        q = [P[:, cn_p[t]] - R[:, cn_r[t]] for t in range(slots)]
        valid = [t < deg for t in range(slots)]
        neg = [x < 0 for x in q]
        total_neg = neg[0]
        for t in range(1, slots):
            total_neg = total_neg ^ (neg[t] & valid[t])
        mags = cn_magnitudes(algo, [x.abs() for x in q], valid, deg)
        R = R.clone()
        total_sign = torch.where(total_neg, -1.0, 1.0)
        for t in range(slots):
            out = (total_sign * torch.where(neg[t], -1.0, 1.0)) * mags[t]
            cols = cn_r[t][valid[t]]
            R[:, cols] = out[:, valid[t]]
        P = L.clone()
        for t in range(int(vn_deg.max())):
            has = t < vn_deg
            P = torch.where(has, P + R[:, (vn_base + t * Z) * has], P)
        return P, R

    def decode(llr):
        batch = llr.shape[0]
        L = torch.empty_like(llr)
        L[:, state] = llr
        P = L.clone()
        R = torch.zeros(batch, code.layout.E * Z)
        done = torch.zeros(batch, dtype=torch.bool)
        iu = torch.full((batch,), iters, dtype=torch.int32)
        for it in range(1, iters + 1):
            if early_stop:
                # the kernel's check of the pre-pass posterior P_{it-1}
                now = syndrome_ok(P) & ~done
                iu = torch.where(now, it - 1, iu)
                done |= now
            P_new, R_new = iteration(L, P, R)
            P = torch.where(done[:, None], P, P_new)
            R = torch.where(done[:, None], R, R_new)
        ok = done | syndrome_ok(P)
        return P[:, state], ok, iu

    return decode


@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("path", ["one-pass", "two-pass"])
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("key", CODES)
def test_table_decoder_matches_plain_decoder(key, normalize, early_stop,
                                             path, algo):
    ref, code = make_code(key)
    shifts, col_off = coordinates(code, normalize)
    plan = flood_plan(code, shifts)
    if path == "one-pass":
        assert plan.bucket in BUCKETS
    llr = frame_llrs(ref)
    got = table_decoder(code, plan, path, col_off, 20, early_stop,
                        algo)(llr)
    P, ok, iu = build_decoder(code, algo, 20, ALPHA, 0.0, "flooding",
                              early_stop, normalize=normalize).posterior(llr)
    # the posterior itself, bit for bit: a VN sum in another order shows
    for name, g, w in zip(("posterior", "ok", "iters_used"), got,
                          (P.reshape(len(llr), -1), ok, iu)):
        assert torch.equal(g.view(torch.int32) if name == "posterior" else g,
                           w.view(torch.int32) if name == "posterior" else w
                           ), name
    assert 0 < int(ok.sum()) < len(llr)  # some frames fail, some pass


def expected_bucket(max_row_deg, m, n, r_slots):
    """Written out apart from choose_bucket: the first of 8, 16, 32 that
    holds the largest row, one check per thread (1024 threads below 32
    slots, 512 at 32), and, above 8, 16-bit indices."""
    if max_row_deg <= 8 and m <= 1024:
        return 8
    if max_row_deg <= 16 and m <= 1024 and max(n, r_slots) <= 1 << 16:
        return 16
    if max_row_deg <= 32 and m <= 512 and max(n, r_slots) <= 1 << 16:
        return 32
    return 0


@pytest.mark.parametrize("family,rate,Z", REGISTRY,
                         ids=[f"{f}-{r}-{z}" for f, r, z in REGISTRY])
def test_bucket_choice_on_registry(family, rate, Z):
    code = LdpcCode.from_family(family, rate, Z)
    lay = code.layout
    plan = flood_plan(code, coordinates(code, False)[0])
    assert plan.bucket == expected_bucket(lay.max_row_deg, lay.m, lay.n,
                                          lay.E * Z)
    # the registry's rows reach 20 (wimax 5/6 Z=48); only wimax 1/2 Z=96
    # (1152 checks) runs the two-pass kernel
    assert (plan.bucket == 0) == ((family, rate, Z) == ("wimax", "1/2", 96))
    if plan.bucket:
        assert lay.max_row_deg <= plan.bucket
        assert lay.m <= plan.threads <= MAX_THREADS[plan.bucket]
        assert plan.threads % 32 == 0 and plan.threads - lay.m < 32
        assert plan.cn_p.shape == plan.cn_r.shape == (plan.bucket, lay.m)
        # every slot's indices inside P and R; above 8 slots in 16 bits
        live = np.arange(plan.bucket)[:, None] < plan.cn_deg[None, :]
        assert plan.cn_p[live].max() < lay.n
        assert plan.cn_r[live].max() < lay.E * Z
        if plan.bucket > 8:
            assert max(lay.n, lay.E * Z) <= PACK_LIMIT
    else:
        assert plan.threads == 256 and plan.cn_p.size == 0


def test_bucket_choice_edges():
    """The judged code runs 8 slots at 512 threads; a row of degree 33,
    and more checks than a block holds, take the two-pass kernel."""
    judged = LdpcCode.judged()
    plan = flood_plan(judged, coordinates(judged, False)[0])
    assert (plan.bucket, plan.threads) == (8, 512)
    for deg, bucket in ((1, 8), (8, 8), (9, 16), (16, 16), (17, 32),
                        (32, 32), (33, 0), (200, 0)):
        assert choose_bucket(deg, 100, 1000, 5000) == bucket
    assert choose_bucket(7, 1025, 2000, 5000) == 0
    assert choose_bucket(20, 513, 2000, 5000) == 0
    assert choose_bucket(12, 500, 70000, 5000) == 0
    B = np.full((2, 40), -1)
    B[0, :] = np.arange(40) % 5
    B[1, :4] = [1, 2, 3, 4]
    wide = LdpcCode.from_base_graph(B, 5, "deg40")
    assert flood_plan(wide, coordinates(wide, False)[0]).bucket == 0


def sweep_values(step):
    """float32 values: signed zeros, subnormals, huge, grid points k*step,
    halfway points (k + 1/2)*step and their neighbours, random."""
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    sub = np.array([f32(1e-45), f32(3e-45), tiny / f32(2), tiny / f32(3),
                    tiny * f32(0.999), tiny, tiny * f32(1.5)], f32)
    k = np.arange(-70, 71, dtype=np.float64)
    grid = (k * step).astype(f32)
    half = ((k + 0.5) * step).astype(f32)
    near = np.concatenate([np.nextafter(half, f32(np.inf)),
                           np.nextafter(half, f32(-np.inf))])
    rng = np.random.default_rng(11)
    rand = (rng.normal(size=4000) * 10.0 ** rng.uniform(-8, 5, 4000)
            ).astype(f32)
    big = np.array([1e4, -1e4, 3e4, -3e4, 1e30, -1e30, 3.4e38, -3.4e38],
                   f32)
    out = np.concatenate([np.array([0.0, -0.0], f32), sub, -sub, big, grid,
                          half, near, rand])
    return out.astype(f32)


@pytest.mark.parametrize("k", range(-10, 5))
def test_quantizer_reciprocal_is_exact(k):
    """|x| / step == |x| * inv_step bit for bit for step = 2^k (both are
    the correctly rounded value of the same real number |x| * 2^-k), so
    floor(. + 0.5), the quantizer's index, is the same too."""
    step = np.float32(2.0 ** k)
    inv_step = np.float32(1.0) / step
    assert step * inv_step == np.float32(1.0)
    assert np.frexp(step)[0] == 0.5 and np.frexp(inv_step)[0] == 0.5
    x = np.abs(sweep_values(float(step)))
    with np.errstate(over="ignore"):
        quo = x / step
        prod = x * inv_step
    np.testing.assert_array_equal(quo.view(np.uint32), prod.view(np.uint32))
    np.testing.assert_array_equal(np.floor(quo + np.float32(0.5)),
                                  np.floor(prod + np.float32(0.5)))
