"""Plain PyTorch BP decoders (port of ``tpu_ldpc/decode/reference.py``):
the CPU path and the oracle that the CUDA kernels (``decode/cuda_bp.py``)
are held against on the card.

It follows the golden arithmetic contract (``tpu_ldpc/golden/decoder.py``
docstring) exactly, so float32 min-sum is bit-exact against the golden
model, the jnp reference and the Pallas kernel given identical LLRs, on
both schedules:

  * per-edge CN->VN messages R kept in *check coordinates*: R[:, e, r] is
    the message from check r of block-row bi[e] to variable
    (r + shift[e]) % Z of block-col bj[e];
  * circulant gathers are torch.roll along the Z axis (variable->check:
    roll(v, -s); check->variable: roll(r, +s));
  * two-min via a sequential scan in edge order (first-occurrence argmin),
    VN sums accumulated sequentially in ascending block-row order;
  * signs, the syndrome and the hard decision all read ``x < 0``, so
    -0.0 counts as positive everywhere.

Schedules: 'flooding' (all checks, then all variables) and 'layered'
(block-rows in ascending order, each updating the posterior in place:
q = roll(P_col, -s) - R_e, CN update, P_col = roll(q + r_new, +s)).
Early termination checks the syndrome before the first iteration
(iters_used 0) and after each one (iters_used = that iteration).

CN updates: 'minsum' (normalized / offset) and 'sumproduct' (exact:
phi(x) = -log(tanh(x/2)) on |q| clipped to [SP_MIN_MAG, SP_MAX_MAG],
summed in edge order, output (total_sign * own_sign) * phi(tot - phi_e)).
Sum-product's transcendentals round differently on every backend, so it
is compared at frame level, not bit for bit.  'sumproduct-fast' (the
lambda-min2 PWL approximation: a three-smallest scan, then pairwise
soft-mins built from a 3-segment PWL of log(1+e^-x) with power-of-two
slopes) uses only exact or correctly rounded fp32 ops and is bit-exact,
like min-sum.

Fixed-point mode (min-sum only; ``quant_bits`` / ``quant_step`` /
``quant_post_bits``, golden's quantization contract): the channel LLRs
are quantized on entry, VN->CN messages saturated, CN outputs quantized
and the posterior saturated to the wider APP width.  In the layered
schedule the saturation feeds only the CN: the posterior update uses the
unsaturated q, then the APP saturation.

The storage and arithmetic modes of the JAX package's Pallas builder --
shift normalization, rescaled min-sum, bf16 message storage and the
compressed row state -- are keyword arguments of ``build_decoder`` (its
docstring), refused in the JAX builder's combinations (``check_modes``).

Shapes: LLR (batch, n) -> internal (batch, nb, Z); R (batch, E, Z).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.decode.normalize import coordinates

# Sum-product stability clips, the golden model's (golden/decoder.py)
SP_MIN_MAG = 1e-9     # lower clip on |Q| before phi()
SP_MAX_MAG = 30.0     # upper clip on |Q|; tanh(15) saturates fp32 anyway


def _block_structure(code: LdpcCode):
    """Static protograph structure, edges sorted by (row, col)."""
    lay = code.layout
    edges = [
        (int(i), int(j), int(s))
        for i, j, s in zip(lay.edge_row, lay.edge_col, lay.edge_shift)
    ]
    row_edges = [lay.row_edges(i) for i in range(lay.mb)]
    col_edges = [lay.col_edges(j) for j in range(lay.nb)]
    return edges, row_edges, col_edges


def _signs(qs):
    return [torch.where(q < 0, -1.0, 1.0).to(q.dtype) for q in qs]


def _product(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def _cn_minsum(qs, alpha: float, beta: float):
    """Two-min CN update with the golden scan semantics.

    qs: list of (batch, Z) VN->CN messages of one block-row, edge order.
    Returns the list of (batch, Z) CN->VN messages."""
    d = len(qs)
    mags = [q.abs() for q in qs]
    sgns = _signs(qs)
    min1 = mags[0]
    min2 = torch.full_like(min1, float("inf"))
    argmin = torch.zeros_like(min1, dtype=torch.int32)
    for e in range(1, d):
        m = mags[e]
        is_new_min = m < min1
        min2 = torch.where(is_new_min, min1, torch.minimum(min2, m))
        argmin = torch.where(is_new_min, e, argmin)
        min1 = torch.where(is_new_min, m, min1)
    total_sign = _product(sgns)
    if d == 1:
        min2 = min1  # golden: a single-edge row sends its own magnitude
    outs = []
    for e in range(d):
        mag_excl = torch.where(argmin == e, min2, min1)
        mag_excl = torch.clamp_min(mag_excl - beta, 0.0)
        outs.append((total_sign * sgns[e]) * (alpha * mag_excl))
    return outs


def _phi(x):
    """phi(x) = -log(tanh(x/2)) on x clipped to [SP_MIN_MAG, SP_MAX_MAG].
    At the top clip tanh rounds to 1 and phi is -0.0: the message's sign
    comes from the sign product it is multiplied by, as in golden."""
    x = torch.clamp(x, SP_MIN_MAG, SP_MAX_MAG)
    return -torch.log(torch.tanh(x * 0.5))


def _cn_sumproduct(qs):
    """Exact sum-product CN update (golden's stable sign / phi form).
    The phi sum runs in edge order."""
    mags = [q.abs() for q in qs]
    sgns = _signs(qs)
    phis = [_phi(m) for m in mags]
    tot = phis[0]
    for p in phis[1:]:
        tot = tot + p
    total_sign = _product(sgns)
    return [(total_sign * sgns[e]) * _phi(tot - phis[e])
            for e in range(len(qs))]


def quant_params(bits: int, step: float, post_bits: int | None = None):
    """(step, kmax, lim_msg, lim_post) as fp32-exact Python floats: the
    grid step, the largest grid index 2^(bits-1)-1 and the two saturation
    limits, computed in fp32 as golden's ``saturate`` computes them.
    post_bits defaults to bits + 2.

    step must be a power of two: |x|/step is then an exact exponent
    shift, so every backend rounds the quantizer's +0.5 the same way."""
    bits = int(bits)
    post_bits = bits + 2 if post_bits is None else int(post_bits)
    step = float(step)
    if not (step > 0 and math.frexp(step)[0] == 0.5):
        raise ValueError(
            f"quant_step must be a power of two (got {step}): other steps "
            "make |x|/step rounding backend-dependent and break the "
            "bit-exact contract")
    f32 = np.float32

    def lim(b):
        return float(f32(f32((1 << (b - 1)) - 1) * f32(step)))

    return step, float((1 << (bits - 1)) - 1), lim(bits), lim(post_bits)


def make_quantizers(bits: int, step: float, post_bits: int | None = None):
    """(quantize, sat_msg, sat_post) on float32 tensors, bit-exact with
    golden's ``quantize`` / ``saturate``: k = min(floor(|x|/step + 0.5),
    2^(bits-1)-1), then (sign(x) * k) * step, and +0.0 (never -0.0) where
    k == 0; the saturations are clips to the fp32 limits."""
    step, kmax, lim_msg, lim_post = quant_params(bits, step, post_bits)

    def quantize(x):
        k = torch.clamp_max(torch.floor(x.abs() / step + 0.5), kmax)
        signed = (torch.where(x < 0, -1.0, 1.0).to(x.dtype) * k) * step
        return torch.where(k == 0, 0.0, signed).to(x.dtype)

    def _sat(lim):
        return lambda x: torch.clamp(x, -lim, lim)

    return quantize, _sat(lim_msg), _sat(lim_post)


def _ctilde(x):
    """3-segment PWL of log(1+e^-x); the slopes are powers of two, so the
    products are exact and no fused multiply-add can round otherwise."""
    return torch.clamp_min(
        torch.maximum(torch.maximum(0.6931472 - 0.5 * x, 0.57 - 0.25 * x),
                      0.40 - 0.125 * x),
        0.0)


def _fpair(a, b):
    """PWL pairwise soft-min of two magnitudes."""
    d1 = _ctilde(a + b)
    d2 = _ctilde((a - b).abs())
    return torch.clamp_min(torch.minimum(a, b) + (d1 - d2), 0.0)


def _cn_sumproduct_fast(qs):
    """lambda-min2 sum-product (golden's sumproduct-fast contract):
    three-smallest scan with first-occurrence argmins a1, a2 (strict <);
    a degree-1 row sends its own magnitude, a degree-2 row each edge the
    other's; otherwise edge a1 gets f(m2, m3), a2 f(m1, m3), the rest
    f(m1, m2)."""
    d = len(qs)
    mags = [q.abs() for q in qs]
    sgns = _signs(qs)
    total_sign = _product(sgns)
    if d == 1:
        outs = [mags[0]]
    elif d == 2:
        outs = [mags[1], mags[0]]
    else:
        m1 = mags[0]
        m2 = torch.full_like(m1, float("inf"))
        m3 = m2
        a1 = torch.zeros_like(m1, dtype=torch.int32)
        a2 = torch.full_like(a1, -1)
        for t in range(1, d):
            mt = mags[t]
            lt1 = mt < m1
            lt2 = ~lt1 & (mt < m2)
            lt3 = ~lt1 & ~lt2 & (mt < m3)
            m3 = torch.where(lt1 | lt2, m2, torch.where(lt3, mt, m3))
            m2 = torch.where(lt1, m1, torch.where(lt2, mt, m2))
            a2 = torch.where(lt1, a1, torch.where(lt2, t, a2))
            m1 = torch.where(lt1, mt, m1)
            a1 = torch.where(lt1, t, a1)
        f23, f13, f12 = _fpair(m2, m3), _fpair(m1, m3), _fpair(m1, m2)
        outs = [torch.where(a1 == t, f23, torch.where(a2 == t, f13, f12))
                for t in range(d)]
    return [(total_sign * sgns[e]) * outs[e] for e in range(d)]


def _syndrome_ok(P, edges, row_edges):
    """(batch,) bool: H @ hard(P) == 0, via rolled XOR over block-rows."""
    bits = P < 0  # (batch, nb, Z)
    ok = None
    for es in row_edges:
        acc = None
        for e in es:
            _, j, s = edges[e]
            v = torch.roll(bits[:, j, :], -s, dims=-1)
            acc = v if acc is None else acc ^ v
        row_ok = ~acc.any(dim=-1)
        ok = row_ok if ok is None else ok & row_ok
    return ok


def is_bf16(msg_dtype) -> bool:
    """True for bf16 message storage; None and torch.float32 are float32."""
    if msg_dtype is None or msg_dtype == torch.float32:
        return False
    if msg_dtype == torch.bfloat16:
        return True
    raise ValueError(f"msg_dtype must be None, torch.float32 or "
                     f"torch.bfloat16, got {msg_dtype!r}")


def check_modes(code: LdpcCode, algo: str, iters: int, beta: float,
                schedule: str, quant_bits, rescaled: bool, msg_dtype,
                compressed: bool) -> None:
    """Refuse what the JAX package's build_pallas_decoder refuses, with
    its exception types and in its order (pallas_bp.py:368-381, 459-483)."""
    if algo not in ("minsum", "sumproduct", "sumproduct-fast"):
        raise ValueError(f"unknown algo {algo!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    bf16 = is_bf16(msg_dtype)
    if rescaled and (algo != "minsum" or schedule != "flooding"
                     or beta != 0.0 or compressed or quant_bits is not None
                     or iters > 200 or bf16):
        raise ValueError(
            "rescaled decoding requires algo='minsum', schedule='flooding',"
            " beta=0, full-precision messages, no quantization and"
            " iters <= 200")
    if quant_bits is not None:
        if algo != "minsum":
            raise ValueError("quantized decoding supports algo='minsum' only")
        if compressed or bf16:
            raise NotImplementedError(
                "fixed-point quant mode excludes compressed/msg_dtype modes")
    if compressed:
        if algo != "minsum" or schedule != "flooding" or bf16:
            raise NotImplementedError(
                "compressed row state: minsum + flooding + f32 only")
        if code.layout.max_row_deg > 8:
            raise NotImplementedError(
                "compressed row state packs signs into int8: row degree <= 8")


@functools.lru_cache(maxsize=64)
def build_decoder(
    code: LdpcCode,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    early_stop: bool = True,
    quant_bits: int | None = None,
    quant_step: float = 0.5,
    quant_post_bits: int | None = None,
    *,
    normalize: bool = False,
    rescaled: bool = False,
    msg_dtype=None,
    compressed: bool = False,
    dtype=torch.float32,
):
    """Plain decoder: llr (batch, n) float32 on any device ->
    (bits uint8 (batch, n), ok bool (batch,), iters_used int32 (batch,)).

    dtype: the arithmetic type, as the JAX reference decoder's `dtype`:
    the LLRs are cast to it and R is allocated in it, so every message
    and posterior is computed and rounded in it (torch.bfloat16 agrees
    with the JAX reference's bf16 on most frames, not bit for bit: XLA
    may keep excess precision inside a fusion).

    quant_bits / quant_step / quant_post_bits: fixed-point mode (min-sum
    only; post bits default to quant_bits + 2).

    The storage and arithmetic modes of the JAX package's
    build_pallas_decoder (refused in the same combinations,
    ``check_modes``):

    - normalize: decode in the rotated coordinates of
      ``decode/normalize.py`` (LLRs rotated per column on entry, the
      posterior un-rotated on exit); outputs are unchanged.  Ignored with
      ``compressed``, as in the JAX package.
    - rescaled: golden's min-sum-rescaled contract: the CN runs with
      alpha 1, and the channel term Ls is multiplied by fp32(1)/fp32(alpha)
      once per iteration before the VN sum (Ls_k = Ls_{k-1} * inv).
    - msg_dtype=torch.bfloat16: R stored rounded to bf16 (round to nearest
      even), computed in float32.  Flooding: the CN's q and the VN sums
      read the rounded R.  Layered: q reads the rounded R, the posterior
      update takes the unrounded CN output, only the store rounds.
    - compressed: flooding min-sum keeping per check (min1', min2', argmin
      slot, sign byte) in place of R, with min' = alpha * max(min - beta,
      0) and bit t of the byte the sign of slot t's message; R is rebuilt
      from them, exactly, in the next CN pass and in the VN pass.

    ``decode_fn.posterior(llr)`` returns (P (batch, nb, Z), ok,
    iters_used) instead, for tests of the posterior itself."""
    check_modes(code, algo, iters, beta, schedule, quant_bits, rescaled,
                msg_dtype, compressed)
    shifts, col_off = coordinates(code, normalize and not compressed)
    edges, row_edges, col_edges = _block_structure(code)
    edges = [(i, j, s) for (i, j, _), s in zip(edges, shifts)]
    Z, mb, nb, E = code.Z, code.mb, code.nb, len(edges)
    rotated = any(col_off)
    # float32 constants, as the golden model rounds them
    f32 = np.float32
    alpha = float(f32(alpha))
    beta = float(f32(beta))
    inv_alpha = float(f32(1.0) / f32(alpha))
    qz = sat_msg = sat_post = None
    if quant_bits is not None:
        qz, sat_msg, sat_post = make_quantizers(quant_bits, quant_step,
                                                quant_post_bits)
    if is_bf16(msg_dtype):
        def store(r):
            return r.to(torch.bfloat16).to(torch.float32)
    else:
        def store(r):
            return r

    def cn_update(qs):
        if algo == "minsum":
            if rescaled:
                return _cn_minsum(qs, 1.0, 0.0)
            outs = _cn_minsum(qs, alpha, beta)
            return outs if qz is None else [qz(o) for o in outs]
        if algo == "sumproduct-fast":
            return _cn_sumproduct_fast(qs)
        return _cn_sumproduct(qs)

    def vn_pass(base, msg):
        """P: base + the column's messages (msg(e), check coordinates)
        scattered back, in ascending block-row order."""
        cols = []
        for j in range(nb):
            p = base[:, j, :]
            for e in col_edges[j]:
                p = p + torch.roll(msg(e), edges[e][2], dims=-1)
            cols.append(p if sat_post is None else sat_post(p))
        return torch.stack(cols, dim=1)

    def flooding_iter(L, state):
        # state (P, R[, Ls]); R in check coordinates
        P, R = state[:2]
        R_new = [None] * E
        for es in row_edges:
            qs = []
            for e in es:
                _, j, s = edges[e]
                q = torch.roll(P[:, j, :], -s, dims=-1) - R[:, e, :]
                qs.append(q if sat_msg is None else sat_msg(q))
            for e, r_out in zip(es, cn_update(qs)):
                R_new[e] = store(r_out)
        R_new = torch.stack(R_new, dim=1)
        if rescaled:
            Ls = state[2] * inv_alpha
            return vn_pass(Ls, lambda e: R_new[:, e, :]), R_new, Ls
        return vn_pass(L, lambda e: R_new[:, e, :]), R_new

    def compressed_iter(L, state):
        # state (P, M1, M2, ARG, SGN); the row state (batch, mb, Z) in
        # check coordinates
        P, rs = state[0], state[1:]

        def reconstruct(rs, e):
            M1, M2, ARG, SGN = rs
            i = edges[e][0]
            slot = e - row_edges[i][0]
            mag = torch.where(ARG[:, i] == slot, M2[:, i], M1[:, i])
            return torch.where((SGN[:, i] >> slot) & 1 == 1, -mag, mag)

        rows = []
        for es in row_edges:
            qs = []
            for e in es:
                _, j, s = edges[e]
                qs.append(torch.roll(P[:, j, :], -s, dims=-1)
                          - reconstruct(rs, e))
            mags = [q.abs() for q in qs]
            negs = [(q < 0).to(torch.int32) for q in qs]
            min1 = mags[0]
            min2 = torch.full_like(min1, float("inf"))
            argm = torch.zeros_like(min1, dtype=torch.int32)
            for t in range(1, len(qs)):
                new = mags[t] < min1
                min2 = torch.where(new, min1, torch.minimum(min2, mags[t]))
                argm = torch.where(new, t, argm)
                min1 = torch.where(new, mags[t], min1)
            if len(qs) == 1:
                min2 = min1
            total = negs[0]
            for ng in negs[1:]:
                total = total ^ ng
            sgn = sum((total ^ ng) << t for t, ng in enumerate(negs))
            rows.append((alpha * torch.clamp_min(min1 - beta, 0.0),
                         alpha * torch.clamp_min(min2 - beta, 0.0), argm,
                         sgn))
        rs = tuple(torch.stack(x, dim=1) for x in zip(*rows))
        return (vn_pass(L, lambda e: reconstruct(rs, e)), *rs)

    def layered_iter(L, state):
        # block-rows in ascending order, the posterior updated in place
        # (on lists of column / edge tensors, so the inputs stay intact)
        P, R = state
        cols, msgs = list(P.unbind(1)), list(R.unbind(1))
        for es in row_edges:
            qs_raw = []
            for e in es:
                _, j, s = edges[e]
                qs_raw.append(torch.roll(cols[j], -s, dims=-1) - msgs[e])
            # saturation feeds the CN only; the posterior update keeps
            # the unsaturated q (golden's wide-APP datapath)
            qs = qs_raw if sat_msg is None else [sat_msg(q) for q in qs_raw]
            for e, q, r_out in zip(es, qs_raw, cn_update(qs)):
                _, j, s = edges[e]
                p_new = q + r_out  # the unrounded message, as the kernel
                if sat_post is not None:
                    p_new = sat_post(p_new)
                cols[j] = torch.roll(p_new, s, dims=-1)
                msgs[e] = store(r_out)
        return torch.stack(cols, dim=1), torch.stack(msgs, dim=1)

    def rotate(X, sign):
        """Per-column roll by sign * col_off: -1 into the rotated
        coordinates, +1 back."""
        return torch.stack([torch.roll(X[:, j, :], sign * c, dims=-1)
                            for j, c in enumerate(col_off)], dim=1)

    def init_state(L):
        batch = L.shape[0]

        def zeros(rows, kind=None):
            return torch.zeros((batch, rows, Z), dtype=kind or L.dtype,
                               device=L.device)

        if compressed:
            return (L, zeros(mb), zeros(mb), zeros(mb, torch.int32),
                    zeros(mb, torch.int32))
        if rescaled:
            return L, zeros(E), L
        return L, zeros(E)

    if compressed:
        iteration = compressed_iter
    elif schedule == "flooding":
        iteration = flooding_iter
    else:
        iteration = layered_iter

    def decode_posterior(L):
        batch = L.shape[0]
        state = init_state(L)
        if early_stop:
            done = _syndrome_ok(state[0], edges, row_edges)
            iu = torch.where(done, 0, iters).to(torch.int32)
            for it in range(1, iters + 1):
                if bool(done.all()):
                    break  # every codeword frozen: the rest is a no-op
                keep = done[:, None, None]
                state = tuple(torch.where(keep, old, new) for old, new
                              in zip(state, iteration(L, state)))
                ok_now = _syndrome_ok(state[0], edges, row_edges)
                iu = torch.where(ok_now & ~done, it, iu).to(torch.int32)
                done = done | ok_now
            return state[0], done, iu
        for _ in range(iters):
            state = iteration(L, state)
        iu = torch.full((batch,), iters, dtype=torch.int32, device=L.device)
        return state[0], _syndrome_ok(state[0], edges, row_edges), iu

    def posterior(llr: torch.Tensor):
        llr = llr.to(dtype)
        if qz is not None:
            llr = qz(llr)  # channel-entry quantization
        L = llr.reshape(llr.shape[0], nb, Z)
        if not rotated:
            return decode_posterior(L)
        P, ok, iu = decode_posterior(rotate(L, -1))
        return rotate(P, 1), ok, iu

    def decode_fn(llr: torch.Tensor):
        P, ok, iu = posterior(llr)
        bits = (P < 0).reshape(P.shape[0], nb * Z).to(torch.uint8)
        return bits, ok, iu

    decode_fn.posterior = posterior
    return decode_fn


def decode(code: LdpcCode, llr, **kw):
    """Decode a batch of LLRs (a tensor, or an array on the CPU) with the
    plain decoder ``build_decoder(code, **kw)``."""
    return build_decoder(code, **kw)(torch.as_tensor(llr))
