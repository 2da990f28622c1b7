"""Minimum-distance tools (the port's copy of ``tpu_ldpc/codes/dmin.py``).

The registry's FER deep-floor evidence is statistical; d_min bounds give
the complementary structural view a construction library is expected to
provide.

- ``gf2_nullspace_basis(H)``: a (k', n) GF(2) basis of the code
  (handles rank-deficient H, e.g. SC chains; k' = n - rank).
- ``dmin_exact(H)``: exact minimum distance by chunked enumeration of
  all nonzero codewords — tiny codes only (dimension <= ~22).
- ``dmin_upper_bound(H)``: probabilistic information-set search
  (Leon/Stern family, p<=2): repeatedly put the code in systematic
  form over a random information set and scan all single rows and row
  pairs of the systematic generator.  Returns the best weight, the
  certificate codeword (verified against H), and search stats.  This
  is the workhorse at real blocklengths — measured on the judged
  (1024, 512) code it finds lower-weight codewords in under a second
  than thousands of decoder-impulse trials (weight 18 vs 19).
- ``dmin_upper_bound_qc(code)``: QC restricted-subcode search
  (Rosnes/Ytrehus-style, bounded) — fixes the plain search's
  saturation at long blocklength / low rate by bounding every subcode
  supported on <= 2 info block-columns + the parity columns
  (measured: wifi_r12_z81 270 -> 38).
- ``estimate_dmin_impulse(code)``: decoder-based error-impulse upper
  bound (kept as an independent cross-check; effective on short codes,
  measured ineffective at n >= 1024 where BP corrects any noiseless
  impulse pattern — see the docstring).  Its probes decode in one batch
  through exact sum-product on the card (K3, ``build_cuda_decoder``)
  unless the caller asks for ``device='cpu'``.

Everything else is host-side analysis tooling: NumPy GF(2) with the RREF
hot loop on the native bit-packed helper (``tpu_ldpc_torch/_native``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp



def _dense(H) -> np.ndarray:
    return np.asarray(sp.csr_matrix(H).todense(), dtype=np.uint8) % 2


def gf2_nullspace_basis(H, verify: bool = True) -> np.ndarray:
    """(k', n) uint8 basis of {c : H c^T = 0 (mod 2)}; k' = n - rank(H).

    Row b is the codeword with a 1 in free column b (and only there
    among the free columns), so the basis is in systematic form over
    the free-column information set.

    verify=False skips the O(n^2 k') H @ basis check — used by the ISD
    restart loop, where that dense matmul dominated the whole search
    (the final certificate is still verified against H either way).
    """
    from tpu_ldpc_torch import _native

    Hd = _dense(H)
    # the bit-packed native RREF: the ISD loop runs this once per restart
    # (codes/gf2.py's NumPy version, the same semantics, is what the tests
    # hold it against)
    rref, pivots = _native.gf2_row_reduce(Hd)
    n = Hd.shape[1]
    piv = np.asarray(pivots, dtype=np.int64)
    free = np.setdiff1d(np.arange(n), piv)
    basis = np.zeros((len(free), n), dtype=np.uint8)
    basis[np.arange(len(free)), free] = 1
    if len(piv):
        # pivot-column bits solve H c = 0 given the free bits
        basis[:, piv] = rref[: len(piv), :][:, free].T
    if verify:
        assert (Hd.astype(np.int64) @ basis.T.astype(np.int64)
                % 2 == 0).all()
    return basis


def dmin_exact(H, max_dim: int = 22, chunk: int = 1 << 16) -> int:
    """Exact d_min by enumerating all 2^k' - 1 nonzero codewords.

    Raises ValueError when the code dimension exceeds ``max_dim``
    (enumeration is exponential — this is for toy/unit-test codes and
    for anchoring the probabilistic searches).
    """
    basis = gf2_nullspace_basis(H)
    kdim = basis.shape[0]
    if kdim == 0:
        raise ValueError("code has dimension 0 (H has full column rank)")
    if kdim > max_dim:
        raise ValueError(
            f"code dimension {kdim} > max_dim {max_dim}: enumeration "
            "infeasible; use dmin_upper_bound")
    best = basis.shape[1] + 1
    bb = basis.astype(np.int64)
    exps = np.arange(kdim, dtype=np.uint64)
    for lo in range(1, 1 << kdim, chunk):
        idx = np.arange(lo, min(lo + chunk, 1 << kdim), dtype=np.uint64)
        msgs = ((idx[:, None] >> exps[None, :]) & 1).astype(np.int64)
        w = ((msgs @ bb) % 2).sum(axis=1)
        best = min(best, int(w.min()))
    return best


def _pack64(rows: np.ndarray) -> np.ndarray:
    """(k, n) uint8 bits -> (k, ceil(n/64)) uint64 words."""
    packed = np.packbits(rows, axis=1)
    pad = (-packed.shape[1]) % 8
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    return packed.view(np.uint64)


def dmin_upper_bound(H, restarts: int = 200, seed: int = 0,
                     target: int | None = None):
    """Probabilistic minimum-distance upper bound via information-set
    search (Leon/Stern family with p <= 2).

    Per restart: apply a random column permutation, compute the
    systematic nullspace basis over the induced information set, and
    take the minimum Hamming weight over all k basis rows (p=1) and
    all k(k-1)/2 row pairs (p=2) — every such sum is a codeword, so
    each weight certifies d_min <= w.  A minimum-weight codeword of
    weight d is found by a restart whose information set contains at
    most 2 of its d support positions; over random permutations that
    happens with substantial probability for small d, so the bound
    converges quickly (judged (1024,512) code: weight 18 inside 20
    restarts, <1 s).

    target: stop early once a weight <= target is certified.
    Returns (best_w, codeword, stats); codeword is verified against H.
    """
    if restarts < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    Hd = _dense(H)
    n = Hd.shape[1]
    rng = np.random.default_rng(seed)
    best_w, best_c = n + 1, None
    for r in range(int(restarts)):
        perm = rng.permutation(n)
        B = gf2_nullspace_basis(Hd[:, perm], verify=False)
        k = B.shape[0]
        if k == 0:
            raise ValueError("code has dimension 0")
        P64 = _pack64(B)
        w1 = np.bitwise_count(P64).sum(axis=1)
        i = int(w1.argmin())
        if int(w1[i]) < best_w:
            best_w, comb = int(w1[i]), B[i]
            best_c = np.zeros(n, np.uint8)
            best_c[perm] = comb
        for i in range(k - 1):
            w2 = np.bitwise_count(P64[i] ^ P64[i + 1:]).sum(axis=1)
            j = int(w2.argmin())
            if int(w2[j]) < best_w:
                best_w, comb = int(w2[j]), B[i] ^ B[i + 1 + j]
                best_c = np.zeros(n, np.uint8)
                best_c[perm] = comb
        if target is not None and best_w <= target:
            break
    _verify_certificate(Hd, best_c, best_w)
    stats = {"restarts": r + 1, "p": 2, "dim": int(B.shape[0])}
    return best_w, best_c, stats


def _verify_certificate(Hd: np.ndarray, c, w: int) -> None:
    """Certificate check for a claimed weight-w codeword.

    Raises RuntimeError (NOT AssertionError: must survive ``python -O``
    and must not be swallowed by callers that catch AssertionError as a
    routine "search skipped" condition).
    """
    if c is None:
        raise RuntimeError("d_min search returned no certificate codeword")
    if not (Hd.astype(np.int64) @ c.astype(np.int64) % 2 == 0).all():
        raise RuntimeError("d_min certificate is not a codeword of H")
    if int(c.sum()) != w:
        raise RuntimeError(
            f"d_min certificate weight {int(c.sum())} != claimed {w}")


def _exact_min_word(basis: np.ndarray, chunk: int = 1 << 16):
    """(min_weight, argmin codeword) over all nonzero combinations of
    the given (small) basis."""
    kdim, n = basis.shape
    bb = basis.astype(np.int64)
    exps = np.arange(kdim, dtype=np.uint64)
    best_w, best_c = n + 1, None
    for lo in range(1, 1 << kdim, chunk):
        idx = np.arange(lo, min(lo + chunk, 1 << kdim), dtype=np.uint64)
        msgs = ((idx[:, None] >> exps[None, :]) & 1).astype(np.int64)
        words = (msgs @ bb) % 2
        w = words.sum(axis=1)
        i = int(w.argmin())
        if int(w[i]) < best_w:
            best_w, best_c = int(w[i]), words[i].astype(np.uint8)
    return best_w, best_c


def dmin_upper_bound_qc(code, max_info_cols: int = 2, restarts: int = 25,
                        exact_dim: int = 16, seed: int = 0):
    """QC-aware minimum-distance upper bound via restricted subcodes
    (Rosnes/Ytrehus-style constraint-subset search, bounded).

    Rationale: at n >= ~1300, R=1/2 the plain p<=2 information-set
    search saturates (it needs an information set catching <= 2 support
    positions of a min-weight word — probability ~1e-7 per restart).
    But low-weight codewords of dual-diagonal QC families concentrate
    on FEW info block-columns plus the weight-2 parity chain, and a
    codeword supported only on column subset S is exactly a nullspace
    element of H[:, S].  So: for every subset of <= max_info_cols info
    block-columns (plus all parity block-columns), bound the subcode's
    minimum weight — exactly (enumeration) when its dimension is tiny,
    else by ISD at a now-favorable rate (dim ~ t*Z over (t+mb)*Z
    length).  Every result is still a verified codeword of the FULL
    code (zero outside S).  Measured: wifi_r12_z54 150 -> 32 vs the
    plain search at equal wall time.

    Assumes the repo's systematic layout (info block-columns first,
    parity last — true for every registry family cell).  Returns
    (best_w, codeword, stats).
    """
    from itertools import combinations

    Hd = _dense(code.H)
    Z, mb, nb = code.Z, code.mb, code.nb
    kb = nb - mb
    n = Hd.shape[1]
    parity_cols = np.arange(kb * Z, nb * Z)
    best_w, best_c = n + 1, None
    n_sub = 0
    for t in range(1, max_info_cols + 1):
        for S in combinations(range(kb), t):
            cols = np.concatenate(
                [np.arange(i * Z, (i + 1) * Z) for i in S] + [parity_cols])
            Hs = Hd[:, cols]
            B = gf2_nullspace_basis(Hs)
            if B.shape[0] == 0:
                continue
            n_sub += 1
            if B.shape[0] <= exact_dim:
                w, c_sub = _exact_min_word(B)
            else:
                # full restart budget per subcode — passing a
                # target derived from best_w here made the first
                # subcode stop after ONE restart (target trivially
                # met) and later ones stop at the first marginal
                # improvement, systematically loosening the bound
                # (wifi_r12_z27 measured 91 after 1 restart vs 63 with
                # the full budget)
                w, c_sub, _ = dmin_upper_bound(Hs, restarts=restarts,
                                               seed=seed)
            if w < best_w:
                best_w = w
                best_c = np.zeros(n, np.uint8)
                best_c[cols] = c_sub
    if best_c is None:
        raise ValueError("no nonempty restricted subcode found")
    _verify_certificate(Hd, best_c, best_w)
    return best_w, best_c, {"subcodes": n_sub,
                            "max_info_cols": max_info_cols}


def estimate_dmin_impulse(
    code,
    gammas=(0.6, 1.0, 1.6, 2.4),
    pairs: int = 512,
    iters: int = 60,
    algo: str = "sumproduct",
    base_llr: float = 8.0,
    seed: int = 0,
    decoder=None,
    device="cuda",
):
    """Decoder-based error-impulse upper bound.  Returns (ub, stats).

    For every code position i and every impulse strength gamma, decode
    the all-zero-codeword LLR vector (+base_llr everywhere) with
    position i forced to -gamma*base_llr; additionally ``pairs`` random
    position pairs get simultaneous impulses.  Every converged nonzero
    output is a valid codeword (syndrome-checked by the decoder), so
    its weight certifies d_min <= weight.  ub is None when no probe
    converged to a nonzero codeword.

    MEASURED REACH (the JAX package's decoders; K3 on the card also
    finds 0 hits on the judged code): tight on short codes (toy n=24
    QC: finds the exact d_min=4); at n >= 1024 noiseless impulses are
    simply corrected (0 hits across base_llr 0.5-8, gamma up to 50,
    pinned-bit and syndrome-guided decimation variants included) — BP
    at high reliability decodes back to zero or stalls, it does not
    walk to a neighboring codeword.  Use ``dmin_upper_bound`` there;
    this method stays as an independent decoder-family cross-check on
    short codes.

    decoder: optional override, llr (batch, n) float32 tensor on
    `device` -> (bits, ok, iters); defaults to ``build_cuda_decoder(code,
    algo, iters, early_stop=True)`` in the code's own coordinates: the
    CUDA kernel on the card (exact sum-product: K3), the plain PyTorch
    decoder (``decode/reference.py::build_decoder``) for
    ``device='cpu'``.
    """
    import torch

    from tpu_ldpc_torch.codes_device import resolve_device

    device = resolve_device(device)
    if decoder is None:
        from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

        decoder = build_cuda_decoder(code, algo, iters, early_stop=True,
                                     normalize=False)
    n = code.n
    rng = np.random.default_rng(seed)
    probes = []
    for g in gammas:
        block = np.full((n, n), base_llr, np.float32)
        block[np.arange(n), np.arange(n)] = -g * base_llr
        probes.append(block)
    if pairs:
        i = rng.integers(0, n, size=pairs)
        j = (i + 1 + rng.integers(0, n - 1, size=pairs)) % n
        for g in gammas[-2:]:
            block = np.full((pairs, n), base_llr, np.float32)
            block[np.arange(pairs), i] = -g * base_llr
            block[np.arange(pairs), j] = -g * base_llr
            probes.append(block)
    llr = np.concatenate(probes, axis=0)

    out = decoder(torch.from_numpy(llr).to(device))
    bits, ok = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in out[:2])
    w = bits.sum(axis=1).astype(np.int64)
    hit = np.asarray(ok, bool) & (w > 0)
    stats = {
        "probes": int(llr.shape[0]),
        "converged_nonzero": int(hit.sum()),
        "weight_min": int(w[hit].min()) if hit.any() else None,
        "weight_hist": {int(k): int(v) for k, v in
                        zip(*np.unique(w[hit], return_counts=True))},
    }
    return stats["weight_min"], stats
