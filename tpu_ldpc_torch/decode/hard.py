"""Hard-decision decoders (port of ``tpu_ldpc/decode/hard.py``): parallel
majority bit-flipping (``bitflip``) and single-flip weighted
bit-flipping (``wbf``).

Same contract as every decoder of the port: llr (batch, n) float32 ->
(bits uint8 (batch, n), ok bool (batch,), iters_used int32 (batch,)).
The arithmetic is golden's (``tpu_ldpc/golden/hard.py``), so both are
bit-exact against golden and the JAX package:

  * hard decision ``x = llr < 0`` (-0.0 reads as 0);
  * iters_used is 0 for a frame whose hard decision is already a
    codeword, else ``iters``, set to the first iteration that satisfies
    the syndrome; finished frames are frozen with a ``where``;
  * bitflip flips every bit whose count u of unsatisfied checks has
    2u > column degree: integer arithmetic only;
  * wbf gives each check the reliability w = min |llr| over its edges,
    sums E_j = sum of (2 s_i - 1) w_i over the checks of column j in
    ascending block-row order (fp32), and flips the one bit at
    argmax(E), the first on ties.

Where the JAX package rolls each circulant block, this module gathers:
per (code, device) two index tables, check -> variable (the syndrome and
w) and variable -> check in ascending block-row order (u and E), padded
to the largest degree with an index that reads a pad row: 0 for the
integer sums, +inf for the min, and -0.0 for E, which adds exactly
nothing (x + -0.0 == x for every x, -0.0 included).  The state is held
batch minor, (n, batch), and the tables slot major, so a gather copies
whole rows of frames into (slots, checks or variables, batch) and each
slot is a contiguous slice.  E's terms are added one slot at a time,
never by a reduction whose order the device picks.  The unsatisfied
counts are uint8 sums (a column degree is far below 256) compared as
u > degree // 2, which is 2u > degree for integers.  An iteration is
about twenty tensor ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpu_ldpc_torch.codes.code import LdpcCode
from tpu_ldpc_torch.codes_device import resolve_device


@functools.lru_cache(maxsize=64)
def parity_tables(code: LdpcCode):
    """(chk_var (m, max row degree), var_chk (n, max column degree),
    col_deg (n,)) int64 NumPy tables.

    chk_var[r] lists the variables of check r (pad: n); var_chk[v] the
    checks of variable v in ascending block-row order (pad: m).  Block
    (i, j, s) joins check i*Z + r to variable j*Z + (r + s) % Z."""
    lay, Z = code.layout, code.Z
    r = np.arange(Z)
    rows = [[] for _ in range(code.m)]
    cols = [[] for _ in range(code.n)]
    for i, j, s in zip(lay.edge_row, lay.edge_col, lay.edge_shift):
        var = int(j) * Z + (r + int(s)) % Z
        for chk, v in zip(int(i) * Z + r, var):
            rows[chk].append(v)
            cols[v].append(chk)  # edges run in (row, col) order

    def table(lists, pad):
        out = np.full((len(lists), max(map(len, lists))), pad, np.int64)
        for k, lst in enumerate(lists):
            out[k, :len(lst)] = lst
        return out

    col_deg = np.array([len(c) for c in cols], np.int64)
    return table(rows, code.n), table(cols, code.m), col_deg


class ParityCheck:
    """The parity checks of hard decisions on one device, by gather;
    states are batch minor: (n, batch) and (m, batch)."""

    def __init__(self, code: LdpcCode, device: torch.device):
        chk_var, var_chk, col_deg = parity_tables(code)
        if col_deg.max() > 255:
            raise ValueError("column degree above 255: uint8 counts wrap")
        self.m, self.n = code.m, code.n
        self.dr, self.dc = chk_var.shape[1], var_chk.shape[1]
        # slot major: entry t*m + r is check r's t-th variable
        self.chk_var = torch.from_numpy(chk_var.T.reshape(-1)).to(device)
        self.var_chk = torch.from_numpy(var_chk.T.reshape(-1)).to(device)
        self.half_deg = torch.from_numpy(
            (col_deg // 2).astype(np.uint8)[:, None]).to(device)

    def gather_checks(self, xp: torch.Tensor) -> torch.Tensor:
        """(dr, m, batch): xp (n + 1, batch), its last row the pad, at each
        check's variables."""
        return xp.index_select(0, self.chk_var).view(self.dr, self.m, -1)

    def gather_vars(self, s: torch.Tensor, pad) -> torch.Tensor:
        """(dc, n, batch): s (m, batch) at each variable's checks."""
        sp = F.pad(s, (0, 0, 0, 1), value=pad)
        return sp.index_select(0, self.var_chk).view(self.dc, self.n, -1)

    def syndrome(self, x: torch.Tensor) -> torch.Tensor:
        """(m, batch) uint8 in {0, 1}; x (n, batch) uint8 in {0, 1}.  The
        uint8 sum may wrap, which keeps its parity (256 is even)."""
        xp = F.pad(x, (0, 0, 0, 1))
        return self.gather_checks(xp).sum(0, dtype=torch.uint8) & 1

    def ok(self, bits: torch.Tensor) -> torch.Tensor:
        """(batch,) bool: bits (batch, n) uint8 is a codeword."""
        return self.syndrome(bits.T.contiguous()).amax(dim=0) == 0


def build_hard_decoder(code: LdpcCode, algo: str = "bitflip",
                       iters: int = 50, *, device):
    """Hard decoder on `device`: llr (batch, n) -> (bits, ok, iters_used)."""
    if algo not in ("bitflip", "wbf"):
        raise ValueError(f"unknown hard algo {algo!r}")
    return _build(code, algo, int(iters), resolve_device(device))


@functools.lru_cache(maxsize=64)
def _build(code: LdpcCode, algo: str, iters: int, device: torch.device):
    pc = ParityCheck(code, device)
    n = code.n
    var = torch.arange(n, device=device)[:, None]

    def bitflip_step(x, syn, magp):
        u = pc.gather_vars(syn, 0).sum(0, dtype=torch.uint8)
        return x ^ (u > pc.half_deg).to(torch.uint8)

    def wbf_step(x, syn, magp):
        w = pc.gather_checks(magp).amin(0)  # min: any order
        contrib = (syn.to(torch.float32) * 2 - 1) * w  # (2s - 1) w
        terms = pc.gather_vars(contrib, -0.0)
        E = terms[0]
        for t in range(1, pc.dc):  # ascending block-row order
            E = E + terms[t]
        jstar = E.argmax(dim=0)  # the first index on ties
        return x ^ (var == jstar).to(torch.uint8)

    step = bitflip_step if algo == "bitflip" else wbf_step

    def decode_fn(llr: torch.Tensor):
        llr = llr.to(torch.float32)
        if llr.shape[1] != n:
            raise ValueError(f"llr has {llr.shape[1]} columns, code n={n}")
        llr = llr.T.contiguous()  # (n, batch)
        magp = F.pad(llr.abs(), (0, 0, 0, 1), value=float("inf"))
        x = (llr < 0).to(torch.uint8)
        syn = pc.syndrome(x)
        done = syn.amax(dim=0) == 0
        iu = torch.where(done, 0, iters).to(torch.int32)
        for it in range(1, iters + 1):
            if bool(done.all()):
                break  # every frame frozen: the rest is a no-op
            x = torch.where(done, x, step(x, syn, magp))
            syn = pc.syndrome(x)
            ok_now = syn.amax(dim=0) == 0
            iu = torch.where(ok_now & ~done, it, iu).to(torch.int32)
            done = done | ok_now
        return x.T.contiguous(), done, iu

    return decode_fn
