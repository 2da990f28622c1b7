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
is compared at frame level, not bit for bit.  'sumproduct-fast' (ROADMAP
Queue 2 K4) raises.

Shapes: LLR (batch, n) -> internal (batch, nb, Z); R (batch, E, Z).
"""

from __future__ import annotations

import functools

import torch

from tpu_ldpc_torch.codes.code import LdpcCode

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


@functools.lru_cache(maxsize=64)
def build_decoder(
    code: LdpcCode,
    algo: str = "minsum",
    iters: int = 50,
    alpha: float = 0.75,
    beta: float = 0.0,
    schedule: str = "flooding",
    early_stop: bool = True,
):
    """Plain decoder: llr (batch, n) float32 on any device ->
    (bits uint8 (batch, n), ok bool (batch,), iters_used int32 (batch,)).

    ``decode_fn.posterior(llr)`` returns (P (batch, nb, Z), ok,
    iters_used) instead, for tests of the posterior itself."""
    if algo == "sumproduct-fast":
        raise NotImplementedError(
            "algo='sumproduct-fast' is not ported yet (ROADMAP Queue 2 K4)")
    if algo not in ("minsum", "sumproduct"):
        raise ValueError(f"unknown algo {algo!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    edges, row_edges, col_edges = _block_structure(code)
    Z, nb, E = code.Z, code.nb, len(edges)
    # float32 constants, as the golden model rounds them
    alpha = float(torch.tensor(alpha, dtype=torch.float32))
    beta = float(torch.tensor(beta, dtype=torch.float32))

    def cn_update(qs):
        if algo == "minsum":
            return _cn_minsum(qs, alpha, beta)
        return _cn_sumproduct(qs)

    def flooding_iter(L, P, R):
        # CN pass (per block-row), R in check coordinates
        R_new = [None] * E
        for es in row_edges:
            qs = []
            for e in es:
                _, j, s = edges[e]
                qs.append(torch.roll(P[:, j, :], -s, dims=-1) - R[:, e, :])
            for e, r_out in zip(es, cn_update(qs)):
                R_new[e] = r_out
        R_new = torch.stack(R_new, dim=1)
        # VN pass: sequential accumulation in ascending block-row order
        cols = []
        for j in range(nb):
            p = L[:, j, :]
            for e in col_edges[j]:
                p = p + torch.roll(R_new[:, e, :], edges[e][2], dims=-1)
            cols.append(p)
        return torch.stack(cols, dim=1), R_new

    def layered_iter(L, P, R):
        # block-rows in ascending order, the posterior updated in place
        # (on lists of column / edge tensors, so the inputs stay intact)
        cols, msgs = list(P.unbind(1)), list(R.unbind(1))
        for es in row_edges:
            qs = []
            for e in es:
                _, j, s = edges[e]
                qs.append(torch.roll(cols[j], -s, dims=-1) - msgs[e])
            for e, q, r_out in zip(es, qs, cn_update(qs)):
                _, j, s = edges[e]
                cols[j] = torch.roll(q + r_out, s, dims=-1)
                msgs[e] = r_out
        return torch.stack(cols, dim=1), torch.stack(msgs, dim=1)

    iteration = flooding_iter if schedule == "flooding" else layered_iter

    def posterior(llr: torch.Tensor):
        llr = llr.to(torch.float32)
        batch = llr.shape[0]
        L = llr.reshape(batch, nb, Z)
        P = L
        R = torch.zeros((batch, E, Z), dtype=torch.float32, device=llr.device)
        if early_stop:
            done = _syndrome_ok(P, edges, row_edges)
            iu = torch.where(done, 0, iters).to(torch.int32)
            for it in range(1, iters + 1):
                if bool(done.all()):
                    break  # every codeword frozen: the rest is a no-op
                P_new, R_new = iteration(L, P, R)
                keep = done[:, None, None]
                P = torch.where(keep, P, P_new)
                R = torch.where(keep, R, R_new)
                ok_now = _syndrome_ok(P, edges, row_edges)
                iu = torch.where(ok_now & ~done, it, iu).to(torch.int32)
                done = done | ok_now
            return P, done, iu
        for _ in range(iters):
            P, R = iteration(L, P, R)
        iu = torch.full((batch,), iters, dtype=torch.int32, device=llr.device)
        return P, _syndrome_ok(P, edges, row_edges), iu

    def decode_fn(llr: torch.Tensor):
        P, ok, iu = posterior(llr)
        bits = (P < 0).reshape(P.shape[0], nb * Z).to(torch.uint8)
        return bits, ok, iu

    decode_fn.posterior = posterior
    return decode_fn
