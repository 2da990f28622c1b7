"""Plain PyTorch flooding min-sum decoder (port of
``tpu_ldpc/decode/reference.py``): the CPU path and the oracle that the
CUDA kernel (``decode/cuda_bp.py``) is held against on the card.

It follows the golden arithmetic contract (``tpu_ldpc/golden/decoder.py``
docstring) exactly, so float32 min-sum is bit-exact against the golden
model, the jnp reference and the Pallas kernel given identical LLRs:

  * per-edge CN->VN messages R kept in *check coordinates*: R[:, e, r] is
    the message from check r of block-row bi[e] to variable
    (r + shift[e]) % Z of block-col bj[e];
  * circulant gathers are torch.roll along the Z axis (variable->check:
    roll(v, -s); check->variable: roll(r, +s));
  * two-min via a sequential scan in edge order (first-occurrence argmin),
    VN sums accumulated sequentially in ascending block-row order;
  * signs, the syndrome and the hard decision all read ``x < 0``, so
    -0.0 counts as positive everywhere.

Shapes: LLR (batch, n) -> internal (batch, nb, Z); R (batch, E, Z).
Only algo='minsum' with the flooding schedule is ported; the layered
schedule (ROADMAP Queue 2 K2) and sum-product (K3, K4) raise.
"""

from __future__ import annotations

import functools

import torch

from tpu_ldpc.codes.code import LdpcCode


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


def _cn_minsum(qs, alpha: float, beta: float):
    """Two-min CN update with the golden scan semantics.

    qs: list of (batch, Z) VN->CN messages of one block-row, edge order.
    Returns the list of (batch, Z) CN->VN messages."""
    d = len(qs)
    mags = [q.abs() for q in qs]
    sgns = [torch.where(q < 0, -1.0, 1.0).to(q.dtype) for q in qs]
    min1 = mags[0]
    min2 = torch.full_like(min1, float("inf"))
    argmin = torch.zeros_like(min1, dtype=torch.int32)
    for e in range(1, d):
        m = mags[e]
        is_new_min = m < min1
        min2 = torch.where(is_new_min, min1, torch.minimum(min2, m))
        argmin = torch.where(is_new_min, e, argmin)
        min1 = torch.where(is_new_min, m, min1)
    total_sign = sgns[0]
    for e in range(1, d):
        total_sign = total_sign * sgns[e]
    if d == 1:
        min2 = min1  # golden: a single-edge row sends its own magnitude
    outs = []
    for e in range(d):
        mag_excl = torch.where(argmin == e, min2, min1)
        mag_excl = torch.clamp_min(mag_excl - beta, 0.0)
        outs.append((total_sign * sgns[e]) * (alpha * mag_excl))
    return outs


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
    (bits uint8 (batch, n), ok bool (batch,), iters_used int32 (batch,))."""
    if algo in ("sumproduct", "sumproduct-fast"):
        raise NotImplementedError(
            f"algo={algo!r} is not ported yet (ROADMAP Queue 2 "
            f"{'K3' if algo == 'sumproduct' else 'K4'})"
        )
    if algo != "minsum":
        raise ValueError(f"unknown algo {algo!r}")
    if schedule == "layered":
        raise NotImplementedError(
            "schedule='layered' is not ported yet (ROADMAP Queue 2 K2, "
            "Queue 1 item 5)"
        )
    if schedule != "flooding":
        raise ValueError(f"unknown schedule {schedule!r}")
    edges, row_edges, col_edges = _block_structure(code)
    Z, nb, E = code.Z, code.nb, len(edges)
    # float32 constants, as the golden model rounds them
    alpha = float(torch.tensor(alpha, dtype=torch.float32))
    beta = float(torch.tensor(beta, dtype=torch.float32))

    def flooding_iter(L, P, R):
        # CN pass (per block-row), R in check coordinates
        R_new = [None] * E
        for es in row_edges:
            qs = []
            for e in es:
                _, j, s = edges[e]
                qs.append(torch.roll(P[:, j, :], -s, dims=-1) - R[:, e, :])
            for e, r_out in zip(es, _cn_minsum(qs, alpha, beta)):
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

    def decode_fn(llr: torch.Tensor):
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
                P_new, R_new = flooding_iter(L, P, R)
                keep = done[:, None, None]
                P = torch.where(keep, P, P_new)
                R = torch.where(keep, R, R_new)
                ok_now = _syndrome_ok(P, edges, row_edges)
                iu = torch.where(ok_now & ~done, it, iu).to(torch.int32)
                done = done | ok_now
            ok = done
        else:
            for _ in range(iters):
                P, R = flooding_iter(L, P, R)
            ok = _syndrome_ok(P, edges, row_edges)
            iu = torch.full((batch,), iters, dtype=torch.int32,
                            device=llr.device)
        bits = (P < 0).reshape(batch, nb * Z).to(torch.uint8)
        return bits, ok, iu

    return decode_fn
