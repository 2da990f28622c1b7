"""Row-striped (intra-codeword) BP decoding over ranks (port of
``tpu_ldpc/dist/partitioned.py``): the path for codes whose message
state one kernel block cannot hold (``decode/api.py`` routes them here,
or to the ring decoder of ``dist/ring.py``, when given a mesh).

Check block-rows are cut into contiguous stripes, one per rank (sizes as
``np.linspace(0, mb, n + 1)``); each rank owns the CN->VN messages R of
its stripe.  The posterior P is replicated: after its local CN pass a
rank scatters its stripe's messages into a partial posterior, and one
``all_reduce`` rebuilds P on every rank; one ``all_reduce`` of the
violation count decides early termination.

Like the JAX package's ``jnp`` prototype this is plain torch ops (no
kernel): ``LocalPass`` runs a set of check rows with gather tables built
once, rows of one degree at a time, so an iteration costs a few dozen
ops whatever the code's size.  The state is batch minor, (variables,
batch), as in the JAX package.  The all_reduce sums the ranks' partial
posteriors in the backend's order, so results are deterministic for a
given mesh but not bit-exact with the single-device decoder (tests hold
them to syndrome-valid outputs and >= 0.95 frame agreement).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ldpc_torch.decode.reference import (
    _cn_minsum,
    _cn_sumproduct,
    _cn_sumproduct_fast,
)
from tpu_ldpc_torch.dist.mesh import Mesh
from tpu_ldpc_torch.spans import spanned


def cn_update_fn(algo: str, alpha: float, beta: float):
    """The CN update of `algo` on a list of VN->CN messages (the plain
    decoder's, with alpha and beta rounded to float32 as it does)."""
    if algo == "minsum":
        alpha, beta = float(np.float32(alpha)), float(np.float32(beta))
        return lambda qs: _cn_minsum(qs, alpha, beta)
    if algo == "sumproduct-fast":
        return _cn_sumproduct_fast
    if algo == "sumproduct":
        return _cn_sumproduct
    raise ValueError(f"unknown algo {algo!r}")


class LocalPass:
    """The CN pass and scatter of some check rows of a code over a window
    of its block-columns, the work one rank does between collectives.

    rows: block-rows, ascending; every edge of them lies in block-columns
    [col0, col0 + n_cols).  The window's posterior is (n_cols * Z, batch);
    R holds the rows' messages, (edge_slots, batch), in check coordinates
    (R[e, r] is the message of check r of the edge's row), rows grouped
    by degree.  ``__call__`` returns the window's scatter C (each column
    the sum of its messages in ascending row order, from +0.0, as the
    JAX package adds them), the new R and the rows' syndrome violations
    (batch,)."""

    def __init__(self, code, rows, col0: int, n_cols: int, cn_update):
        lay = code.layout
        Z = lay.Z
        self.cn_update, self.Z = cn_update, Z
        by_deg: dict[int, list[int]] = {}
        for i in rows:
            es = lay.row_edges(i)
            if len(es):
                by_deg.setdefault(len(es), []).append(i)
        self.groups = []  # (degree, rows, first slot, P index table)
        col_msgs: list[list[tuple[int, int, int]]] = [[] for _ in range(n_cols)]
        slot = 0
        z = np.arange(Z)
        for d, grows in sorted(by_deg.items()):
            p_idx = np.empty((len(grows), d, Z), np.int64)
            for ri, i in enumerate(grows):
                for k, e in enumerate(lay.row_edges(i)):
                    c = int(lay.edge_col[e]) - col0
                    s = int(lay.edge_shift[e])
                    assert 0 <= c < n_cols
                    # check r reads variable (r + s) % Z of column c
                    p_idx[ri, k] = c * Z + (z + s) % Z
                    col_msgs[c].append((i, slot + (ri * d + k) * Z, s))
            self.groups.append((d, len(grows), slot, p_idx.reshape(-1)))
            slot += len(grows) * d * Z
        self.edge_slots = slot
        # variable z of column c sums message (z - s) % Z of its edges in
        # ascending row order; padded with the zero row at `slot`
        depth = max((len(m) for m in col_msgs), default=0)
        v_idx = np.full((depth, n_cols * Z), slot, np.int64)
        for c, msgs in enumerate(col_msgs):
            for t, (_, base, s) in enumerate(sorted(msgs)):
                v_idx[t, c * Z:(c + 1) * Z] = base + (z - s) % Z
        self.v_idx, self.n_rows = v_idx, n_cols * Z
        self._tables = {}

    def tables(self, device):
        if device not in self._tables:
            self._tables[device] = (
                [torch.from_numpy(g[3]).to(device) for g in self.groups],
                torch.from_numpy(self.v_idx).to(device))
        return self._tables[device]

    def violations(self, P: torch.Tensor) -> torch.Tensor:
        """(batch,) int64: unsatisfied checks of the rows under P."""
        p_tabs, _ = self.tables(P.device)
        viol = torch.zeros(P.shape[1], dtype=torch.int64, device=P.device)
        for (d, n, _, _), p_idx in zip(self.groups, p_tabs):
            neg = (P.index_select(0, p_idx) < 0).view(n, d, self.Z, -1)
            viol += (neg.sum(1) % 2).sum((0, 1))
        return viol

    def __call__(self, P: torch.Tensor, R: torch.Tensor):
        p_tabs, v_idx = self.tables(P.device)
        batch = P.shape[1]
        viol = torch.zeros(batch, dtype=torch.int64, device=P.device)
        R_new = []
        for (d, n, slot, _), p_idx in zip(self.groups, p_tabs):
            t = P.index_select(0, p_idx).view(n, d, self.Z, batch)
            viol += ((t < 0).sum(1) % 2).sum((0, 1))
            r = R[slot:slot + n * d * self.Z].view(n, d, self.Z, batch)
            outs = self.cn_update([t[:, k] - r[:, k] for k in range(d)])
            R_new.append(torch.stack(outs, dim=1).reshape(-1, batch))
        R_new = torch.cat(R_new + [P.new_zeros((1, batch))])
        C = torch.zeros((self.n_rows, batch), dtype=P.dtype, device=P.device)
        for row in v_idx:
            C = C + R_new.index_select(0, row)
        return C, R_new[:-1], viol


def decode_loop(L, R0, iters: int, one_iter, violations):
    """The early-termination loop of the sharded decoders, in JAX's form.

    one_iter(P, R) -> (P_next, R_next, viol) with viol the all-reduced
    count of the checks P violates, so every rank holds the same `done`
    and leaves the loop at the same iteration.  Iteration `it` tests the
    posterior it starts from: a frame valid there freezes with
    iters_used = it - 1; a last test of the final posterior gives
    iters_used = iters."""
    batch = L.shape[1]
    P, R = L, R0
    done = torch.zeros(batch, dtype=torch.bool, device=L.device)
    iu = torch.full((batch,), iters, dtype=torch.int32, device=L.device)
    for it in range(1, iters + 1):
        P_new, R_new, viol = one_iter(P, R)
        ok_now = viol == 0
        iu = torch.where(ok_now & ~done, it - 1, iu).to(torch.int32)
        done = done | ok_now
        P = torch.where(done, P, P_new)
        R = torch.where(done, R, R_new)
        if bool(done.all()):  # the same on every rank: viol is reduced
            return P, done, iu
    ok_now = violations(P) == 0
    iu = torch.where(ok_now & ~done, iters, iu).to(torch.int32)
    return P, done | ok_now, iu


@functools.lru_cache(maxsize=16)
def build_partitioned_decoder(code, mesh: Mesh, algo: str = "minsum",
                              iters: int = 50, alpha: float = 0.75,
                              beta: float = 0.0):
    """Row-striped decoder: llr (batch, n), the same on every rank ->
    (bits uint8 (batch, n), ok bool, iters_used int32), the same on
    every rank, on the LLRs' device.  Needs mesh.size <= mb (each rank
    gets at least one block-row)."""
    lay = code.layout
    Z, mb, nb = lay.Z, lay.mb, lay.nb
    n_ranks = mesh.size
    if n_ranks > mb:
        raise ValueError(f"{n_ranks} devices > {mb} block rows")
    bounds = np.linspace(0, mb, n_ranks + 1).astype(int)
    local = LocalPass(code, range(bounds[mesh.rank], bounds[mesh.rank + 1]),
                      0, nb, cn_update_fn(algo, alpha, beta))

    def violations(P):
        return mesh.all_reduce(local.violations(P))

    @spanned("ldpc.decode")
    def decode_fn(llr: torch.Tensor):
        L = llr.to(torch.float32).T.contiguous()  # (n, batch)

        def one_iter(P, R):
            C, R_new, viol_loc = local(P, R)
            viol = mesh.all_reduce(viol_loc)
            return L + mesh.all_reduce(C), R_new, viol

        R0 = L.new_zeros((local.edge_slots, L.shape[1]))
        P, ok, iu = decode_loop(L, R0, iters, one_iter, violations)
        return (P < 0).T.to(torch.uint8).contiguous(), ok, iu

    return decode_fn
