"""Column-partitioned ring BP decoding (port of ``tpu_ldpc/dist/ring.py``):
the long-blocklength path for banded codes.

Block-columns are cut into contiguous shards, one per rank.  For a
banded base graph (each row's block-columns within a narrow window;
spatially-coupled chains are the canonical case) every check row goes to
the rank owning its rightmost block-column, so a rank updates its rows
from its own columns plus a `halo`-wide window of its left neighbour's,
and each column's posterior from its own rows plus the contributions
returned by its right neighbour.  An iteration makes three collectives,
in the JAX package's order:

    1. P of the last `halo` block-columns  -> right neighbour
       (local CN pass over the owned rows; local scatter)
    2. contributions to the left neighbour's last `halo` columns
                                          -> left neighbour
    3. all_reduce of the violation count (early termination)

The first two are one ``batch_isend_irecv`` each (``Mesh.shift``); the
ranks at the ends take zeros, as ``ppermute`` gives them.  The message
state R never leaves its rank: sharding the columns shards the
O(E * Z * batch) memory.  Columns come out through one ``all_gather``.

The posterior is summed in the JAX package's order, ``(L_loc +
C_ext[halo:])`` and then ``+ ret`` on the last `halo` columns, each
column's scatter in ascending row order from +0.0, so min-sum equals the
JAX ring decoder bit for bit on the CPU.  Plain torch ops, as the JAX
package's ``jnp`` prototype (``dist/partitioned.py::LocalPass``).
"""

from __future__ import annotations

import functools

import torch

from tpu_ldpc_torch.dist.mesh import Mesh
from tpu_ldpc_torch.dist.partitioned import (
    LocalPass, cn_update_fn, decode_loop)
from tpu_ldpc_torch.spans import spanned


def ring_geometry(code, n_ranks: int):
    """(block-cols per rank, halo, owner rank of each row with edges,
    refusal): refusal is None when the ring can run `code` over
    `n_ranks` ranks, else the reason (the JAX package's message)."""
    lay = code.layout
    mb, nb = lay.mb, lay.nb
    if nb % n_ranks:
        return None, None, None, (
            f"nb={nb} block-columns not divisible by {n_ranks} devices")
    cpd = nb // n_ranks
    row_cols = {}
    for i in range(mb):
        es = lay.row_edges(i)
        if len(es):
            cols = [int(lay.edge_col[e]) for e in es]
            row_cols[i] = (min(cols), max(cols))
    # the halo is owner-aligned: a row reads back from its owner's first
    # column to its own leftmost one, not over its whole span
    owner = {i: cmax // cpd for i, (_, cmax) in row_cols.items()}
    halo = max((owner[i] * cpd - cmin for i, (cmin, _) in row_cols.items()),
               default=0)
    # halo 0 (a block-diagonal base) would make the last-`halo` slices
    # empty; one spare column costs nothing
    halo = max(halo, 1)
    if halo > cpd:
        return cpd, halo, owner, (
            f"band width {halo} exceeds the {cpd} block-cols per device "
            f"(nb={nb}, {n_ranks} devices): a single-hop neighbor halo "
            "cannot span multiple shards — use fewer devices or the "
            "row-striped partitioned decoder")
    return cpd, halo, owner, None


def fits_ring(code, n_ranks: int) -> bool:
    """True when the ring can run `code` over `n_ranks` ranks."""
    return ring_geometry(code, n_ranks)[3] is None


def is_banded(code) -> bool:
    """True when every check row's block-columns span at most half of the
    base's width (a spatially-coupled chain, not a dense base)."""
    lay = code.layout
    spans = [int(lay.edge_col[es].max() - lay.edge_col[es].min()) + 1
             for es in (lay.row_edges(i) for i in range(lay.mb)) if len(es)]
    return 2 * max(spans, default=0) <= lay.nb


@functools.lru_cache(maxsize=16)
def build_ring_decoder(code, mesh: Mesh, algo: str = "minsum",
                       iters: int = 50, alpha: float = 0.75,
                       beta: float = 0.0):
    """Ring decoder for banded QC codes: llr (batch, n), the same on every
    rank -> (bits uint8 (batch, n), ok bool, iters_used int32), the same
    on every rank, on the LLRs' device.  Needs nb divisible by the ranks
    and the owner-aligned band at most the block-cols per rank
    (ValueError otherwise)."""
    cpd, halo, owner, refusal = ring_geometry(code, mesh.size)
    if refusal is not None:
        raise ValueError(refusal)
    Z = code.Z
    j0 = mesh.rank * cpd
    rows = [i for i in sorted(owner) if owner[i] == mesh.rank]
    # the window is the halo then the rank's own columns
    local = LocalPass(code, rows, j0 - halo, cpd + halo,
                      cn_update_fn(algo, alpha, beta))
    h = halo * Z

    def violations(P_loc):
        P_ext = torch.cat([mesh.shift(P_loc[-h:], 1), P_loc])
        return mesh.all_reduce(local.violations(P_ext))

    @spanned("ldpc.decode")
    def decode_fn(llr: torch.Tensor):
        L = llr.to(torch.float32).T[j0 * Z:(j0 + cpd) * Z].contiguous()

        def one_iter(P_loc, R):
            P_ext = torch.cat([mesh.shift(P_loc[-h:], 1), P_loc])  # 1
            C_ext, R_new, viol_loc = local(P_ext, R)
            ret = mesh.shift(C_ext[:h], -1)                           # 2
            P_next = L + C_ext[h:]
            P_next[-h:] += ret
            return P_next, R_new, mesh.all_reduce(viol_loc)           # 3

        R0 = L.new_zeros((local.edge_slots, L.shape[1]))
        P, ok, iu = decode_loop(L, R0, iters, one_iter, violations)
        bits = mesh.all_gather((P < 0).to(torch.uint8))
        return bits.reshape(-1, L.shape[1]).T.contiguous(), ok, iu

    return decode_fn
