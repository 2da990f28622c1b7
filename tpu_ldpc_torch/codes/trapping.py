"""Trapping-set census of decoder failures (the port's copy of
``tpu_ldpc/codes/trapping.py``).

The nr2 floor-regime claim ("trapping-set, not distance, limited") rests
on d_min <= 43 plus a handful of undetected errors; this module MEASURES
the mechanism: harvest failed frames at the floor operating point,
classify each frame's residual error support as an (a, b) class — a =
|wrong variable nodes|, b = |unsatisfied checks of that support| — and
report the dominant classes with multiplicities.  b == 0 identifies the
support as a codeword (an UNDETECTED error whose weight lower-bounds
d_min); small (a, b) with b > 0 are the classic trapping sets that pin
min-sum below the waterfall slope.

The error support is taken from the FINAL hard decision (failed
min-sum frames can oscillate; the final state is what the decoder
actually emits, and per-frame supports recur across noise draws when
a structural set is responsible — the census counts distinct supports
per class exactly for that signal).

Harvest runs through any batch decoder; by default the port's flooding
min-sum with early termination, on the card (the CUDA kernel K1) unless
the caller asks for ``device='cpu'`` (the plain PyTorch decoder).
Frames are generated host-side, with NumPy, exactly as the JAX package
draws them (one ``default_rng(crc32(f"{tag}/{ebn0}/{chunk}"))`` per
chunk), so a chunk holds the same frames in both packages and a census is
reproducible bit for bit.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import defaultdict

import numpy as np


@dataclasses.dataclass(frozen=True)
class Failure:
    """One failed frame's residual-error structure."""

    a: int                 # wrong variable nodes (over the FULL codeword)
    b: int                 # unsatisfied checks of that support
    support: tuple         # sorted wrong-bit indices
    chunk: int             # paired-seed chunk index (reproducibility)
    lane: int              # frame index within the chunk
    info_wrong: int        # wrong bits within the info block


def classify(H, c_true: np.ndarray, bits: np.ndarray, k: int,
             chunk: int = 0) -> list[Failure]:
    """(a, b) classification of every failed frame in a batch.

    H: scipy sparse (m, n) parity matrix; c_true/bits: (batch, n)
    uint8 transmitted/decoded codewords; k: info length (for the
    info_wrong column).  Returns one Failure per frame whose decoded
    word differs from the transmitted one anywhere.
    """
    err = (bits ^ c_true).astype(np.uint8)          # (batch, n)
    lanes = np.flatnonzero(err.any(axis=1))
    if lanes.size == 0:
        return []
    # unsatisfied checks of each support: H @ e mod 2, rowwise
    syn = np.asarray((H @ err[lanes].T) % 2)        # (m, |lanes|)
    out = []
    for j, lane in enumerate(lanes):
        support = np.flatnonzero(err[lane])
        out.append(Failure(
            a=int(support.size), b=int(syn[:, j].sum()),
            support=tuple(int(v) for v in support), chunk=chunk,
            lane=int(lane),
            info_wrong=int(err[lane, :k].sum())))
    return out


def chunk_frames(code, M: np.ndarray, tag: str, ebn0_db: float, ci: int,
                 chunk: int, n_punct: int = 0):
    """(codewords uint8 (chunk, n), LLRs float32 (chunk, n)) of paired-seed
    chunk `ci`: random info words encoded with the parity map M, BPSK
    over AWGN at Eb/N0 referenced to k / (n - n_punct), the leading
    n_punct LLRs erased to +0.0."""
    from tpu_ldpc_torch.channel import noise_sigma2
    from tpu_ldpc_torch.codes.gf2 import encode

    sigma2 = noise_sigma2(ebn0_db, code.k / (code.n - n_punct))
    rng = np.random.default_rng(
        zlib.crc32(f"{tag}/{ebn0_db}/{ci}".encode()))
    u = rng.integers(0, 2, (chunk, code.k)).astype(np.uint8)
    c = encode(code.H, u, M)
    x = 1.0 - 2.0 * c.astype(np.float64)
    llr = ((2.0 / sigma2) * (
        x + np.sqrt(sigma2) * rng.normal(size=x.shape))
    ).astype(np.float32)
    if n_punct:
        llr[:, :n_punct] = 0.0
    return c, llr


def harvest_failures(
    code,
    ebn0_db: float,
    *,
    iters: int = 50,
    alpha: float = 0.75,
    target: int = 200,
    max_frames: int = 1 << 20,
    chunk: int = 512,
    seed_tag: str | None = None,
    n_punct: int = 0,
    decode=None,
    progress=None,
    target_info_wrong: bool = False,
    device="cuda",
) -> tuple[list[Failure], int]:
    """Collect >= target failed frames (or stop at max_frames).

    n_punct: leading never-transmitted positions (the NR operating
    condition); Eb/N0 then references the true transmitted rate
    k/(n - n_punct) and those LLRs enter as erasures.
    decode: batch fn llr(float32 NumPy (chunk, n)) -> (bits, ok, iters);
    default: flooding min-sum at `iters` / `alpha` with early
    termination, ``build_cuda_decoder`` on `device` (the LLRs go there
    once per chunk, the bits come back as uint8).  Returns
    (failures, frames_examined) — ALL failed frames are kept and
    classified; target_info_wrong=True makes only info-wrong failures
    (the FER-relevant events) count toward `target`, because in a
    floor regime most failures leave the info block CORRECT with
    residuals confined to parity/punctured columns (nr2_r15: detected
    rate ~10x the info FER — artifacts/nr2_r15_z64_minsum50.csv).
    """
    import torch

    from tpu_ldpc_torch.codes.gf2 import parity_map

    if decode is None:
        from tpu_ldpc_torch.codes_device import resolve_device
        from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

        device = resolve_device(device)
        dec = build_cuda_decoder(code, "minsum", iters, alpha,
                                 early_stop=True, normalize=False)

        def decode(llr):
            return dec(torch.from_numpy(llr).to(device))

    tag = seed_tag if seed_tag is not None else code.name
    M = parity_map(code.H)  # GF(2) reduce ONCE, not per chunk
    failures: list[Failure] = []
    frames = n_target = 0
    while n_target < target and frames < max_frames:
        ci = frames // chunk
        c, llr = chunk_frames(code, M, tag, ebn0_db, ci, chunk, n_punct)
        bits = decode(llr)[0]
        if isinstance(bits, torch.Tensor):
            bits = bits.cpu().numpy()
        bits = np.asarray(bits, dtype=np.uint8)
        new = classify(code.H, c, bits, code.k, chunk=ci)
        failures.extend(new)
        n_target += sum(1 for f in new
                        if f.info_wrong > 0 or not target_info_wrong)
        frames += chunk
        if progress is not None:
            progress(frames, len(failures))
    return failures, frames


def census(failures: list[Failure], top: int = 12) -> dict:
    """Aggregate failures into (a, b) classes.

    Per class: frame count, number of DISTINCT supports (count >>
    distinct means the same structural set keeps trapping the decoder
    across independent noise — the signature of a graph-structural
    floor), and the smallest supports seen.  Codeword-class failures
    (b == 0) are reported separately with their weights — each is a
    live d_min upper-bound certificate.
    """
    by_class: dict[tuple, list] = defaultdict(list)
    for f in failures:
        by_class[(f.a, f.b)].append(f)
    classes = []
    for (a, b), fs in sorted(by_class.items(),
                             key=lambda kv: -len(kv[1]))[:top]:
        supports = {f.support for f in fs}
        classes.append({
            "a": a, "b": b, "count": len(fs),
            "distinct_supports": len(supports),
            "example_support": list(min(supports, key=len))[:64],
        })
    codewords = sorted({f.support for f in failures if f.b == 0},
                       key=len)
    return {
        "n_failures": len(failures),
        "info_wrong_count": sum(1 for f in failures if f.info_wrong > 0),
        "classes": classes,
        "undetected": {
            "count": sum(1 for f in failures if f.b == 0),
            "distinct_codewords": len(codewords),
            "weights": [len(s) for s in codewords[:20]],
        },
        # small-(a,b) mass: fraction of failures from sets with
        # few wrong bits AND few unsatisfied checks — the
        # trapping-regime indicator (waterfall failures are large-a,
        # large-b channel events)
        "small_ab_frac": (
            sum(1 for f in failures if f.a <= 16 and f.b <= 8)
            / max(len(failures), 1)),
    }
