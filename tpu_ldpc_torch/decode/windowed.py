"""Windowed decoding of spatially-coupled (SC) LDPC chains (port of
``tpu_ldpc/decode/windowed.py``).

A window of W block-rows slides down the chain, one row per slide, and
runs a few BP iterations on its rows each time.  Rows behind the window
are committed (their messages freeze) and rows ahead are untouched, so
bits stream out W rows behind the newest received position with state
O(W), not O(L).  The decoder has no global early termination:
iters_used is the constant (mb - W + 1) * iters_per_window.

``make_sc_base_graph`` chains are banded: block-row i's edges are the 6
consecutive block-columns 2(i-2)+j, j = 0..5 (clipped at the chain
ends).  Padding 4 virtual block-columns on each side of the posterior P
and 2 virtual block-rows at each end of the message store R makes every
slide alike: slide p reads padded columns 2p .. 2p+2W+3 and padded rows
p .. p+W+3, the W window rows plus two frozen rows on each side.

Arithmetic, as in the JAX package (and so bit-exact with it for min-sum
and sumproduct-fast; exact sum-product's transcendentals round
otherwise on each backend):

  * row i, edge j reads q = roll(P_c, -S[i, j]) - R_old, c = 2(i-2)+j;
    absent edges take magnitude 1e30 and sign +1 and send 0;
  * the CN update is min-sum (two-min with the first argmin,
    alpha * max(m - beta, 0)), exact sum-product (the phi sum in edge
    order) or sumproduct-fast (the three smallest, first occurrence
    first, and the lambda-min2 PWL pairs of ``reference._fpair``);
  * flooding sweep: the CN on all window rows, then every column of the
    slab is L + its three incidences in ascending row order, the frozen
    rows' stored messages included;
  * layered sweep: rows top to bottom; a row computes all six q's, then
    sets P_c = roll(q + out, S) back for its present edges and stores
    out in R;
  * bits = P < 0 on the real columns; ok is the full chain's syndrome.

Where the JAX package rolls, this module gathers: the tables index the
padded chain once per (code, device), so a slide's rows and columns are
contiguous slices of them.  The flooding sweep gathers the q's of all W
rows at once and the VN pass's incidences of all 2W+4 columns at once
(each column has exactly three); the layered sweep gathers one row at a
time.  The two-min and three-smallest scans are min reductions over the
edge axis: the minimum is exact in any order, and PyTorch's min along a
dimension returns the first index on ties, on the CPU and on CUDA alike,
the scan's first-occurrence rule (which of equal magnitudes ranks first
changes no message anyway: tied values give the edges involved the same
output).  The phi sum keeps its edge order as separate adds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.decode.hard import ParityCheck
from tpu_ldpc_torch.decode.reference import _fpair, _phi

_ABSENT_MAG = 1.0e30  # absent-edge magnitude: never the row minimum
_DEG = 6              # row support width in block-columns (w=2 chains)


def banded_tables(code: LdpcCode):
    """(S, M): per-row shift / presence tables of a banded SC chain.

    S, M are (mb, 6); edge j of block-row i targets block-column
    2(i-2)+j.  Raises ValueError if the base matrix is not banded this
    way (only ``make_sc_base_graph``-shaped chains are supported)."""
    B, mb, nb = np.asarray(code.B), code.mb, code.nb
    S = np.zeros((mb, _DEG), dtype=np.int32)
    M = np.zeros((mb, _DEG), dtype=bool)
    claimed = np.zeros((mb, nb), dtype=bool)
    for i in range(mb):
        for j in range(_DEG):
            g = 2 * (i - 2) + j
            if 0 <= g < nb and B[i, g] >= 0:
                S[i, j] = B[i, g]
                M[i, j] = True
                claimed[i, g] = True
    if not np.array_equal(claimed, B >= 0):
        raise ValueError(
            "base matrix is not a width-2 banded SC chain; windowed "
            "decoding requires make_sc_base_graph structure"
        )
    return S, M


@functools.lru_cache(maxsize=32)
def chain_tables(code: LdpcCode):
    """(qidx (mb, 6, Z), vidx (nb+8, 3, Z)) int64 NumPy gather tables.

    P is (nb+8, Z) padded columns, R (mb+4, 6, Z) padded rows, both
    flattened.  qidx[i, j, r] is the P index that row i, edge j reads at
    lane r: column 2i+j (padded), lane (r + S) % Z.  vidx[g, k, z] is
    the R index of padded column g's k-th incidence (ascending padded
    row pr, edge j = g + 4 - 2pr) at lane z: lane (z - S) % Z."""
    S, _ = banded_tables(code)
    S_pad = np.pad(S, ((2, 2), (0, 0)))
    Z, mb, nb = code.Z, code.mb, code.nb
    r = np.arange(Z)
    i = np.arange(mb)[:, None, None]
    j = np.arange(_DEG)[None, :, None]
    qidx = (2 * i + j) * Z + (r + S[:, :, None]) % Z
    vidx = np.empty((nb + 8, 3, Z), np.int64)
    for g in range(nb + 8):
        # rows pr with 0 <= g + 4 - 2pr <= 5: g // 2 .. g // 2 + 2
        for k, pr in enumerate(range(g // 2, g // 2 + 3)):
            jj = g + 4 - 2 * pr
            vidx[g, k] = (pr * _DEG + jj) * Z + (r - S_pad[pr, jj]) % Z
    return qidx.astype(np.int64), vidx


def _check_node(q, M, edge, algo: str, alpha: float, beta: float):
    """CN outputs of rows stacked as q (..., 6, Z), edges on dim -2.
    M: presence (..., 6, 1) bool, or None where every edge is present;
    edge: arange(6)[:, None] on q's device."""
    mag = q.abs()
    neg = q < 0
    if M is not None:
        mag = torch.where(M, mag, _ABSENT_MAG)
        neg = neg & M
    sgn = torch.where(neg, -1.0, 1.0).to(q.dtype)
    sgn = sgn.prod(dim=-2, keepdim=True) * sgn  # products of +-1: exact
    m1, a1 = mag.min(dim=-2, keepdim=True)  # the first index on ties
    first = edge == a1
    rest = torch.where(first, float("inf"), mag)
    if algo == "minsum":
        m2 = rest.amin(dim=-2, keepdim=True)
        m = torch.where(first, m2, m1)
        if beta:  # max(m - 0, 0) is m itself: m >= 0
            m = torch.clamp_min(m - beta, 0.0)
        out = sgn * (alpha * m)
    elif algo == "sumproduct-fast":
        m2, a2 = rest.min(dim=-2, keepdim=True)
        second = edge == a2
        m3 = torch.where(second, float("inf"), rest).amin(dim=-2,
                                                          keepdim=True)
        f = _fpair(torch.cat([m2, m1, m1], dim=-2),
                   torch.cat([m3, m3, m2], dim=-2))
        f23, f13, f12 = f.split(1, dim=-2)
        out = sgn * torch.where(first, f23, torch.where(second, f13, f12))
    else:
        ph = _phi(mag)  # phi(1e30) is -0.0: an absent edge adds nothing
        tot = ph[..., :1, :]
        for e in range(1, _DEG):  # edge order
            tot = tot + ph[..., e:e + 1, :]
        out = sgn * _phi(tot - ph)
    return out if M is None else torch.where(M, out, 0.0)


def build_windowed_decoder(
    code: LdpcCode,
    window: int,
    iters_per_window: int = 2,
    algo: str = "minsum",
    alpha: float = 0.75,
    beta: float = 0.0,
    sweep: str = "flooding",
    *,
    device,
    dtype=torch.float32,
):
    """Windowed decoder on `device`: llr (batch, n) -> (bits, ok,
    iters_used).

    `window` counts block-rows; each slide runs `iters_per_window`
    iterations on them, then advances one row.  sweep: the schedule
    inside the window, 'flooding' (CN on all window rows, then one VN
    pass) or 'layered' (rows top to bottom, each updating P at once).
    A window of all mb rows is one slide: the plain flooding or layered
    decoder without early termination, bit for bit.  dtype: the
    arithmetic type, as the JAX decoder's: the LLRs are cast to it and R
    is allocated in it."""
    if algo not in ("minsum", "sumproduct", "sumproduct-fast"):
        raise ValueError(f"unknown algo {algo!r}")
    if sweep not in ("flooding", "layered"):
        raise ValueError(f"unknown sweep {sweep!r}")
    banded_tables(code)
    W = int(window)
    if not 1 <= W <= code.mb:
        raise ValueError(f"window must be in [1, mb={code.mb}], got {W}")
    f32 = np.float32
    return _build(code, W, int(iters_per_window), algo, float(f32(alpha)),
                  float(f32(beta)), sweep, resolve_device(device), dtype)


@functools.lru_cache(maxsize=32)
def _build(code, W, ipw, algo, alpha, beta, sweep, device, dtype):
    _, M_np = banded_tables(code)
    qidx_np, vidx_np = chain_tables(code)
    Z, nb, mb = code.Z, code.nb, code.mb
    n_windows = mb - W + 1
    SC = 2 * W + 4  # slab block-columns
    pc = ParityCheck(code, device)
    qidx = torch.from_numpy(qidx_np).to(device)
    vidx = torch.from_numpy(vidx_np).to(device)
    M = torch.from_numpy(M_np[:, :, None]).to(device)
    # per slide: the window rows' q gather, the slab columns' incidences,
    # and the window's presence mask (None where every edge is present)
    slides = [(qidx[p:p + W].reshape(-1), vidx[2 * p:2 * p + SC].reshape(-1),
               None if M_np[p:p + W].all() else M[p:p + W])
              for p in range(n_windows)]
    rows = [(qidx[i].reshape(-1), None if M_np[i].all() else M[i])
            for i in range(mb)]

    edge = torch.arange(_DEG, device=device)[:, None]

    def cn(q, Mq):
        return _check_node(q, Mq, edge, algo, alpha, beta)

    def flooding_slide(p, L, P, R):
        b = P.shape[0]
        qi, vi, Mw = slides[p]
        Pf, Rf = P.view(b, -1), R.view(b, -1)
        win = R[:, p + 2:p + W + 2]  # padded rows of the window
        for _ in range(ipw):
            q = Pf.index_select(1, qi).view(b, W, _DEG, Z) - win
            win.copy_(cn(q, Mw))
            g = Rf.index_select(1, vi).view(b, SC, 3, Z)
            # absent edges hold +0.0 in R, as the reference's mask adds
            P[:, 2 * p:2 * p + SC] = (L[:, 2 * p:2 * p + SC] + g[:, :, 0]
                                      + g[:, :, 1] + g[:, :, 2])

    def layered_slide(p, L, P, R):
        b = P.shape[0]
        Pf = P.view(b, -1)
        for _ in range(ipw):
            for i in range(p, p + W):
                qi, Mi = rows[i]
                q = Pf.index_select(1, qi).view(b, _DEG, Z) - R[:, i + 2]
                out = cn(q, Mi)
                # an absent edge keeps P as it is (q + 0.0 would turn a
                # -0.0 into +0.0)
                p_new = q + out if Mi is None else torch.where(Mi, q + out, q)
                Pf.index_copy_(1, qi, p_new.view(b, -1))
                R[:, i + 2] = out

    slide = flooding_slide if sweep == "flooding" else layered_slide
    total_iters = n_windows * ipw

    def decode_fn(llr: torch.Tensor):
        llr = llr.to(dtype)
        b = llr.shape[0]
        L = F.pad(llr.reshape(b, nb, Z), (0, 0, 4, 4))
        P = L.clone()
        R = torch.zeros((b, mb + 4, _DEG, Z), dtype=dtype,
                        device=llr.device)
        for p in range(n_windows):
            slide(p, L, P, R)
        bits = (P[:, 4:4 + nb] < 0).reshape(b, nb * Z).to(torch.uint8)
        ok = pc.ok(bits)
        iu = torch.full((b,), total_iters, dtype=torch.int32,
                        device=llr.device)
        return bits, ok, iu

    return decode_fn
