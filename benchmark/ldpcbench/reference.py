"""The plain reference of the benchmark: QC-LDPC codes over BPSK-AWGN in
plain NumPy and PyTorch, written from the codes' definition and imported
from nothing of the program under test.

It follows the arithmetic contract that the program's decoders keep bit
for bit (min-sum and sumproduct-fast), so its outputs can be compared
exactly:

* a base matrix B (mb x nb, -1 a zero block) lifted by Z: block (i, j, s)
  joins check r of block-row i to variable (r + s) % Z of block-column j;
  edges are taken in (block-row, block-column) order;
* flooding schedule: every check from the posterior P and the stored
  check-to-variable messages R, then P = L + the column's messages,
  added one at a time in ascending block-row order;
* min-sum: the two smallest |q| of a check (first-occurrence scan),
  out = (sign product * own sign) * (alpha * exclusive minimum);
* sumproduct-fast: the three smallest |q| and a 3-segment piecewise
  linear soft-min with power-of-two slopes;
* signs, the syndrome and the hard decision read ``x < 0``;
* early termination: the syndrome before the first iteration
  (iters_used 0) and after each one; a frame that satisfies it keeps its
  posterior from then on.

The checks of one row are vectorised over the rows (rows padded to the
largest degree with magnitude +inf, which never enters a minimum), and
the frames that have converged are dropped from the work; neither changes
a single rounded operation.

``msg_bf16=True`` stores R rounded to bfloat16 (round to nearest even)
after each check update: the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the float32 constants of the piecewise linear log(1 + e^-x)
_C0, _C1, _C2 = 0.6931472, 0.57, 0.40


class Code:
    """A QC-LDPC code from its base matrix: index tables for the decoder
    and the GF(2) parity map of its systematic encoder."""

    def __init__(self, B, Z: int):
        self.B = np.asarray(B, dtype=np.int64)
        self.Z = int(Z)
        self.mb, self.nb = self.B.shape
        self.n, self.m = self.nb * self.Z, self.mb * self.Z
        self.k = self.n - self.m
        rows, cols = np.nonzero(self.B >= 0)  # row-major: (row, col) order
        self.edges = [(int(i), int(j), int(self.B[i, j]))
                      for i, j in zip(rows, cols)]
        self.E = len(self.edges)
        self.row_deg = np.bincount(rows, minlength=self.mb)
        self.col_deg = np.bincount(cols, minlength=self.nb)
        Z, r = self.Z, np.arange(self.Z)
        # var_of[e, r]: the variable that check r of edge e's block-row
        # reads through edge e
        self.var_of = np.stack([j * Z + (r + s) % Z
                                for _, j, s in self.edges])
        # row_slots[i, t]: the t-th edge of block-row i, or E (a pad)
        dmax = int(self.row_deg.max())
        self.row_slots = np.full((self.mb, dmax), self.E, dtype=np.int64)
        # col_slots[j, t]: the t-th edge of block-column j (ascending
        # block-row), or E (a pad)
        cmax = int(self.col_deg.max())
        self.col_slots = np.full((self.nb, cmax), self.E, dtype=np.int64)
        rfill = np.zeros(self.mb, dtype=np.int64)
        cfill = np.zeros(self.nb, dtype=np.int64)
        for e, (i, j, _) in enumerate(self.edges):
            self.row_slots[i, rfill[i]] = e
            rfill[i] += 1
            self.col_slots[j, cfill[j]] = e
            cfill[j] += 1
        self._tables = {}
        self._parity_map = None

    # --- GF(2) encoding -------------------------------------------------
    def H_dense(self) -> np.ndarray:
        H = np.zeros((self.m, self.n), dtype=np.uint8)
        r = np.arange(self.Z)
        for i, j, s in self.edges:
            H[i * self.Z + r, j * self.Z + (r + s) % self.Z] = 1
        return H

    def parity_map(self) -> np.ndarray:
        """M (m x k) uint8 with parity = M u over GF(2), for H = [A | Hp]
        with Hp invertible: Gauss-Jordan of [Hp | A] on packed bits."""
        if self._parity_map is None:
            H = self.H_dense()
            m, k = self.m, self.k
            aug = np.concatenate([H[:, k:], H[:, :k]], axis=1)
            rows = np.packbits(aug, axis=1)
            for c in range(m):
                byte, bit = c >> 3, 7 - (c & 7)
                col = (rows[:, byte] >> bit) & 1
                cand = np.nonzero(col[c:])[0]
                if cand.size == 0:
                    raise ValueError("the parity part of H is singular")
                p = c + int(cand[0])
                if p != c:
                    rows[[c, p]] = rows[[p, c]]
                    col[[c, p]] = col[[p, c]]
                hit = np.nonzero(col)[0]
                hit = hit[hit != c]
                rows[hit] ^= rows[c]
            bits = np.unpackbits(rows, axis=1, count=m + k)
            self._parity_map = np.ascontiguousarray(bits[:, m:])
        return self._parity_map

    def tables(self, device):
        """The decoder's index tables on `device`."""
        key = str(device)
        if key not in self._tables:
            def t(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)
            self._tables[key] = {
                "var_of": t(self.var_of.reshape(-1)),
                "row_slots": t(self.row_slots),
                # where each column slot's message lies in check
                # coordinates: edge e, check (v - s) % Z for variable v
                "col_msg": t(self._col_msg_index()),
                "row_deg": t(self.row_deg),
                "MT": torch.as_tensor(self.parity_map().T.astype(np.float64),
                                      device=device),
            }
        return self._tables[key]

    def _col_msg_index(self) -> np.ndarray:
        """(nb, cmax, Z) flat indices into R (E * Z, plus one pad slot at
        E * Z) of the message that reaches variable v of column j from
        the column's t-th edge: R[e, (v - s) % Z]."""
        Z, r = self.Z, np.arange(self.Z)
        out = np.full((self.nb,) + self.col_slots.shape[1:] + (Z,),
                      self.E * Z, dtype=np.int64)
        for j in range(self.nb):
            for t, e in enumerate(self.col_slots[j]):
                if e < self.E:
                    s = self.edges[e][2]
                    out[j, t] = e * Z + (r - s) % Z
        return out

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """Codewords [u | M u] (batch, n) uint8 of info bits u (batch, k),
        the parity an exact float64 product."""
        MT = self.tables(u.device)["MT"]
        p = torch.remainder(u.to(torch.float64) @ MT, 2.0).to(torch.uint8)
        return torch.cat([u.to(torch.uint8), p], dim=1)


# --- channel --------------------------------------------------------------
def noise_sigma2(ebn0_db: float, rate: float) -> float:
    """Noise variance per real dimension of BPSK at Eb/N0 and `rate`."""
    return 1.0 / (2.0 * rate * 10.0 ** (ebn0_db / 10.0))


def channel_llrs(c: torch.Tensor, noise: torch.Tensor, ebn0_db: float,
                 rate: float, tx_mask=None) -> torch.Tensor:
    """2 y / sigma^2 with y = (1 - 2c) + sigma * noise, float32 one
    rounded operation at a time, sigma^2 rounded once to float32; with
    `tx_mask` (1 sent, 0 punctured), llr * mask + 0.0, so an erased
    position is exactly +0.0."""
    sigma2 = np.float32(noise_sigma2(float(ebn0_db), rate))
    sigma = float(np.sqrt(sigma2))
    scale = float(np.float32(2.0) / sigma2)
    x = 1.0 - 2.0 * c.to(torch.float32)
    llr = scale * (x + sigma * noise.to(torch.float32))
    if tx_mask is not None:
        llr = llr * tx_mask + torch.zeros_like(tx_mask)
    return llr


# --- decoding ---------------------------------------------------------------
def _sign(x):
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def _ctilde(x):
    return torch.clamp_min(
        torch.maximum(torch.maximum(_C0 - 0.5 * x, _C1 - 0.25 * x),
                      _C2 - 0.125 * x),
        0.0)


def _fpair(a, b):
    d1 = _ctilde(a + b)
    d2 = _ctilde((a - b).abs())
    return torch.clamp_min(torch.minimum(a, b) + (d1 - d2), 0.0)


def _check_update(q, deg, algo: str, alpha: float):
    """q: (F, mb, dmax, Z) variable-to-check messages, pads +inf.
    Returns the check-to-variable messages in the same layout."""
    mags = q.abs()
    sgn = _sign(q)
    total = torch.prod(sgn, dim=2, keepdim=True)  # products of +-1: exact
    dmax = q.shape[2]
    slot = torch.arange(dmax, device=q.device).view(1, 1, dmax, 1)
    if algo == "minsum":
        m1 = mags[:, :, 0]
        m2 = torch.full_like(m1, math.inf)
        a1 = torch.zeros_like(m1, dtype=torch.int64)
        for t in range(1, dmax):
            m = mags[:, :, t]
            new = m < m1
            m2 = torch.where(new, m1, torch.minimum(m2, m))
            a1 = torch.where(new, t, a1)
            m1 = torch.where(new, m, m1)
        one = (deg == 1).view(1, -1, 1)
        m2 = torch.where(one, m1, m2)
        excl = torch.where(slot == a1[:, :, None], m2[:, :, None],
                           m1[:, :, None])
        return (total * sgn) * (alpha * excl)
    if algo != "sumproduct-fast":
        raise ValueError(f"the reference decodes minsum and "
                         f"sumproduct-fast, not {algo!r}")
    m1 = mags[:, :, 0]
    m2 = torch.full_like(m1, math.inf)
    m3 = m2
    a1 = torch.zeros_like(m1, dtype=torch.int64)
    a2 = torch.full_like(a1, -1)
    for t in range(1, dmax):
        mt = mags[:, :, t]
        lt1 = mt < m1
        lt2 = ~lt1 & (mt < m2)
        lt3 = ~lt1 & ~lt2 & (mt < m3)
        m3 = torch.where(lt1 | lt2, m2, torch.where(lt3, mt, m3))
        m2 = torch.where(lt1, m1, torch.where(lt2, mt, m2))
        a2 = torch.where(lt1, a1, torch.where(lt2, t, a2))
        m1 = torch.where(lt1, mt, m1)
        a1 = torch.where(lt1, t, a1)
    f23, f13, f12 = (x[:, :, None] for x in
                     (_fpair(m2, m3), _fpair(m1, m3), _fpair(m1, m2)))
    out = torch.where(slot == a1[:, :, None], f23,
                      torch.where(slot == a2[:, :, None], f13, f12))
    # a degree-1 row sends its own magnitude, a degree-2 row the other's
    d = deg.view(1, -1, 1, 1)
    other = mags[:, :, [1, 0] + list(range(2, dmax))] if dmax > 1 else mags
    out = torch.where(d == 1, mags, torch.where(d == 2, other, out))
    return (total * sgn) * out


class Decoder:
    """Flooding BP of `code`: llr (F, n) float32 -> (bits uint8 (F, n),
    ok bool (F,), iters_used int32 (F,))."""

    def __init__(self, code: Code, algo: str = "minsum", iters: int = 50,
                 alpha: float = 0.75, early_stop: bool = True,
                 msg_bf16: bool = False):
        self.code, self.algo, self.iters = code, algo, int(iters)
        self.alpha = float(np.float32(alpha))
        self.early_stop, self.msg_bf16 = bool(early_stop), bool(msg_bf16)

    def _gather_rows(self, x, tab, pad):
        """(F, E*Z) edge values -> (F, mb, dmax, Z), pads `pad`."""
        c = self.code
        F = x.shape[0]
        xe = torch.cat([x.view(F, c.E, c.Z),
                        torch.full((F, 1, c.Z), pad, dtype=x.dtype,
                                   device=x.device)], dim=1)
        return xe[:, tab["row_slots"]]

    def _syndrome_ok(self, P, tab):
        c = self.code
        hard = (P < 0).to(torch.int32)
        per_edge = hard[:, tab["var_of"]]
        rows = self._gather_rows(per_edge, tab, 0)
        return (rows.sum(dim=2) % 2 == 0).flatten(1).all(dim=1)

    def _iteration(self, L, P, R, tab):
        c = self.code
        F = P.shape[0]
        q = P[:, tab["var_of"]] - R  # (F, E*Z)
        qr = self._gather_rows(q, tab, math.inf)
        out = _check_update(qr, tab["row_deg"], self.algo, self.alpha)
        # back to edge order: slot t of row i is edge row_slots[i, t]
        R_new = torch.empty_like(R).view(F, c.E, c.Z)
        valid = tab["row_slots"] < c.E
        R_new[:, tab["row_slots"][valid]] = out[:, valid]
        R_new = R_new.view(F, c.E * c.Z)
        if self.msg_bf16:
            R_new = R_new.to(torch.bfloat16).to(torch.float32)
        # -0.0 pads: x + (-0.0) == x exactly, whatever the sign of x
        Rx = torch.cat([R_new, torch.full((F, 1), -0.0, device=R.device)],
                       dim=1)
        msgs = Rx[:, tab["col_msg"]]  # (F, nb, cmax, Z)
        P_new = L.view(F, c.nb, c.Z)
        for t in range(msgs.shape[2]):
            P_new = P_new + msgs[:, :, t]
        return P_new.reshape(F, c.n), R_new

    def __call__(self, llr: torch.Tensor):
        c = self.code
        tab = self.code.tables(llr.device)
        F = llr.shape[0]
        L = llr.to(torch.float32)
        P_out = L.clone()
        iu = torch.full((F,), self.iters, dtype=torch.int32,
                        device=llr.device)
        if not self.early_stop:
            P, R = L, torch.zeros((F, c.E * c.Z), device=llr.device)
            for _ in range(self.iters):
                P, R = self._iteration(L, P, R, tab)
            return ((P < 0).to(torch.uint8), self._syndrome_ok(P, tab), iu)
        done = self._syndrome_ok(L, tab)
        iu[done] = 0
        active = torch.nonzero(~done).flatten()
        La = L[active]
        P, R = La, torch.zeros((active.numel(), c.E * c.Z),
                               device=llr.device)
        for it in range(1, self.iters + 1):
            if active.numel() == 0:
                break
            P, R = self._iteration(La, P, R, tab)
            ok_now = self._syndrome_ok(P, tab)
            fin = active[ok_now]
            P_out[fin] = P[ok_now]
            iu[fin] = it
            done[fin] = True
            keep = ~ok_now
            active, La, P, R = active[keep], La[keep], P[keep], R[keep]
        P_out[active] = P
        return (P_out < 0).to(torch.uint8), done, iu


# --- Monte-Carlo counters ----------------------------------------------------
COUNTERS = ("frames", "bit_errors", "frame_errors", "detected",
            "undetected", "iter_sum")


def batch_generator(seed: int, snr_idx: int, batch_ctr: int,
                    device, rank: int | None = None) -> torch.Generator:
    """The generator of one Monte-Carlo batch, seeded from (seed, snr_idx,
    batch_ctr) through np.random.SeedSequence: the draw rule of the
    program's Monte-Carlo harness; a rank of a sharded step seeds from
    (seed, snr_idx, batch_ctr, rank)."""
    entropy = [seed, snr_idx, batch_ctr] + ([] if rank is None else [rank])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0] >> np.uint64(1)))
    return gen


class MonteCarlo:
    """The counters of Monte-Carlo batches: draw u then the noise from the
    batch's generator, encode, transmit (punctured positions erased),
    decode, count.  Eb/N0 is referenced to k / n_tx."""

    def __init__(self, code: Code, decoder: Decoder, batch: int,
                 puncture_blocks=(), device="cuda"):
        self.code, self.decoder, self.batch = code, decoder, int(batch)
        self.device = torch.device(device)
        tx = np.ones(code.n, dtype=np.float32)
        for b in puncture_blocks:
            tx[b * code.Z:(b + 1) * code.Z] = 0.0
        n_tx = int(tx.sum())
        self.tx_mask = (None if n_tx == code.n else
                        torch.as_tensor(tx, device=self.device))
        self.rate = code.k / n_tx

    def draw(self, gen):
        u = torch.randint(0, 2, (self.batch, self.code.k), generator=gen,
                          device=self.device, dtype=torch.uint8)
        noise = torch.randn((self.batch, self.code.n), generator=gen,
                            device=self.device, dtype=torch.float32)
        return u, noise

    def batch_counters(self, seed: int, snr_idx: int, ctr: int,
                       ebn0_db: float, rank: int | None = None) -> np.ndarray:
        u, noise = self.draw(batch_generator(seed, snr_idx, ctr, self.device,
                                             rank))
        c = self.code.encode(u)
        llr = channel_llrs(c, noise, ebn0_db, self.rate, self.tx_mask)
        bits, ok, iu = self.decoder(llr)
        wrong = bits[:, :self.code.k] != u
        frame_wrong = wrong.any(dim=1)
        return np.array([u.shape[0], int(wrong.sum()),
                         int(frame_wrong.sum()), int((~ok).sum()),
                         int((ok & frame_wrong).sum()),
                         int(iu.to(torch.int64).sum())], dtype=np.int64)

    def call_counters(self, seed: int, snr_idx: int, ctr0: int,
                      steps: int, ebn0_db: float,
                      ranks: int | None = None) -> np.ndarray:
        """The six counters of batches ctr0 .. ctr0 + steps - 1; with
        `ranks`, summed over the streams of ranks 0 .. ranks - 1."""
        streams = [None] if ranks is None else range(ranks)
        return sum(self.batch_counters(seed, snr_idx, ctr0 + t, ebn0_db, r)
                   for r in streams for t in range(steps))

    def point(self, seed: int, ebn0_db: float, target_frame_errors: int,
              max_frames: int, steps: int) -> np.ndarray:
        """A frame-error-targeted point: calls of `steps` batches until
        frame_errors >= target or frames >= max_frames."""
        acc = np.zeros(6, dtype=np.int64)
        ctr = 0
        while acc[2] < target_frame_errors and acc[0] < max_frames:
            acc += self.call_counters(seed, 0, ctr, steps, ebn0_db)
            ctr += steps
        return acc


def bisection(probe_fer, target_fer: float, lo: float, hi: float,
              tol_db: float):
    """The Eb/N0 search at a target FER: probe both ends, then bisect
    while the bracket is wider than tol_db.  probe_fer(ebn0) gives the FER
    of a probe.  Returns (probe points in order, bracket, converged)."""
    points = []

    def fer(x):
        points.append(x)
        return probe_fer(x)

    if fer(lo) < target_fer:
        return points, (lo, lo), False
    if fer(hi) > target_fer:
        return points, (hi, hi), False
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        if fer(mid) >= target_fer:
            lo = mid
        else:
            hi = mid
    return points, (lo, hi), True
