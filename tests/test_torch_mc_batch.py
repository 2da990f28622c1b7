"""The Monte-Carlo batch kernels' host side (``sim/mc_batch.py``) on the
CPU.

``csrc/mc_batch.cu`` runs only on the card, where ``chip_smoke.py`` holds
it against BatchFn's PyTorch ops bit for bit.  Here NumPy emulations of
its word arithmetic run on the very tables ``BatchKernels`` builds:
kernel A's packed parity table and column map must give the fp64 product
mod 2 and the channel's LLRs bit for bit, kernel B's byte path the
counters of BatchFn's PyTorch ops.  BatchFn's path rule and the
launch counters are pinned.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.channel.adapt import RateAdapt, adapted_llrs_from_noise
from tpu_ldpc_torch.channel.awgn import llr_constants, llrs_from_noise
from tpu_ldpc_torch.codes.base_graphs import (
    make_base_graph, make_sc_base_graph)
from tpu_ldpc_torch.codes.crc import CrcSpec
from tpu_ldpc_torch.codes.nrlike import nrlike_adapt, nrlike_code
from tpu_ldpc_torch.sim import mc_batch
from tpu_ldpc_torch.sim.mc import DecodeCfg, build_batch_fn, run_ber

torch.set_num_threads(1)
CPU = torch.device("cpu")
CFG = DecodeCfg(iters=1)
BATCH = 24  # one full block of kernel A and a part


def _judged():
    return LdpcCode.judged()


def _sc():  # rank-deficient: the pivot encoder
    return LdpcCode.from_base_graph(make_sc_base_graph(4, 8), 8, "sc_l4_z8")


def _odd():  # n = 35, k = 20: kernel A's one position a thread
    return LdpcCode.from_base_graph(make_base_graph(3, 7, 5, seed=3), 5,
                                    "odd_n35")


# name: (code, adapt of the code or None, crc)
CASES = {
    "judged": (_judged, None, None),
    "nrlike": (lambda: nrlike_code("1/2", 64), nrlike_adapt, None),
    "shortened": (_judged, lambda c: RateAdapt.from_blocks(
        c, puncture_blocks=(15,), shorten_blocks=(0, 3)), None),
    "crc24": (_judged, None, "crc24"),
    "crc5": (_judged, None, CrcSpec("crc5", 5, 0x05)),  # kp % 4 == 3
    "pivot": (_sc, None, None),
    "pivot_crc8": (_sc, None, "crc8"),
    "odd_n": (_odd, None, None),
}


def _batch_fn(case, fault_hook=None):
    make_code, make_adapt, crc = CASES[case]
    code = make_code()
    adapt = None if make_adapt is None else make_adapt(code)
    return build_batch_fn(code, CFG, BATCH, adapt, crc, device="cpu",
                          fault_hook=fault_hook)


def _kernels(fn):
    """The BatchKernels a BatchFn builds on the card, built on the CPU."""
    return mc_batch.BatchKernels.of(fn)


def _words(bits: np.ndarray) -> np.ndarray:
    """(F, 32w) 0/1 -> (F, w) uint32, bit b of word w = bits[32w + b]:
    what __ballot_sync packs."""
    F = bits.shape[0]
    return np.packbits(bits.reshape(F, -1, 32), axis=-1,
                       bitorder="little").view("<u4").reshape(F, -1)


def _parity_bit(x: np.ndarray) -> np.ndarray:
    """__popc(x) & 1 of uint32 words."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint32(s))
    return x & np.uint32(1)


def emulate_encode_llr(kern, u, noise, ebn0_db, rate):
    """Kernel A's arithmetic: pack u (masked by active_u), parity words by
    AND / XOR over the table four words at a time, popcount parity,
    codeword bits through the column map, three rounded float32 ops (and
    the masks' two).  Returns (codeword, LLRs)."""
    table = kern.table.numpy().view(np.uint32)
    kwp, mp = table.shape
    F, k = u.shape
    ub = np.zeros((F, kwp * 32), dtype=np.uint8)
    ub[:, :k] = u != 0
    if kern.active_u is not None:
        ub[:, :k] &= kern.active_u.numpy() != 0
    us = _words(ub)
    acc = np.zeros((F, mp), dtype=np.uint32)
    for w in range(0, kwp, 4):
        for q in range(4):
            acc ^= us[:, w + q, None] & table[w + q][None, :]
    p = _parity_bit(acc).astype(np.uint8)
    v = np.concatenate([ub[:, :k], p[:, :kern.n - k]], axis=1)
    c = v if kern.pos is None else v[:, kern.pos.numpy()]
    sigma, scale = (np.float32(x) for x in llr_constants(ebn0_db, rate))
    x = np.where(c != 0, np.float32(-1.0), np.float32(1.0))
    llr = scale * (x + sigma * noise)
    if kern.tx_mask is not None:
        llr = llr * kern.tx_mask.numpy() + kern.known_llr.numpy()
    return c, llr.astype(np.float32)


def emulate_count(kern, bits, u, passed, iters):
    """Kernel B's arithmetic: a byte a lane through info_cols over the
    payload, masked by active_u.  Returns the six counters."""
    k, kp = kern.k, kern.kp
    cols = np.arange(k) if kern.info_cols is None else kern.info_cols.numpy()
    w = bits[:, cols[:kp]] != u[:, :kp]
    if kern.active_u is not None:
        w &= kern.active_u.numpy()[None, :kp] != 0
    wrong = w.sum(axis=1)
    fw = wrong != 0
    return np.array([len(bits), wrong.sum(), fw.sum(), (~passed).sum(),
                     (passed & fw).sum(), iters.astype(np.int64).sum()],
                    dtype=np.int64)


def _inputs(fn, seed):
    gen = torch.Generator().manual_seed(seed)
    return fn.draw(gen)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_llr_emulation_equals_torch_path(case):
    """Kernel A's word arithmetic on the packed table equals the fp64
    product mod 2, and its LLRs the channel's bit for bit (punctured +0.0
    and shortened positions included)."""
    fn = _batch_fn(case)
    kern = _kernels(fn)
    for seed, ebn0 in ((1, 1.0), (2, 2.5)):
        u, noise = _inputs(fn, seed)
        um = u if fn.active_u is None else u * fn.active_u
        want_c = fn.encode_fn(um)  # the fp64 product mod 2
        if fn.tx_mask is not None:
            want = adapted_llrs_from_noise(want_c, noise, ebn0, fn.rate,
                                           fn.tx_mask, fn.known_llr)
        else:
            want = llrs_from_noise(want_c, noise, ebn0, fn.rate)
        c, llr = emulate_encode_llr(kern, u.numpy(), noise.numpy(), ebn0,
                                    fn.rate)
        np.testing.assert_array_equal(c, want_c.numpy())
        np.testing.assert_array_equal(llr.view(np.int32),
                                      want.numpy().view(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_emulation_equals_torch_counters(case):
    """Kernel B's word arithmetic on the sent codewords with planted
    errors equals BatchFn's PyTorch counters (the hook hands both the same
    decoder outputs)."""
    seen = {}

    def plant(gen, bits, ok, iters_used):
        rng = np.random.default_rng(seen["seed"])
        b = seen["codeword"].copy()
        flip = rng.random(b.shape) < 0.01
        flip[::3] = False  # some clean frames
        b ^= flip.astype(np.uint8)
        seen["out"] = (b, rng.random(b.shape[0]) < 0.7,
                       rng.integers(0, 50, b.shape[0]).astype(np.int32))
        return tuple(torch.from_numpy(x) for x in seen["out"])

    fn = _batch_fn(case, fault_hook=plant)
    kern = _kernels(fn)
    for seed in (3, 4):
        seen["seed"] = seed
        u, noise = _inputs(fn, seed)
        um = u if fn.active_u is None else u * fn.active_u
        seen["codeword"] = fn.encode_fn(um).numpy()
        want = fn.batch_counters(u, noise, 2.0).numpy()
        bits, ok, iters = seen["out"]
        passed = ok
        if fn.crc_ok is not None:
            info = (bits[:, :fn.k_info] if fn.info_cols is None
                    else bits[:, fn.info_cols.numpy()])
            passed = fn.crc_ok(torch.from_numpy(info)).numpy()
        got = emulate_count(kern, bits, u.numpy(), passed, iters)
        np.testing.assert_array_equal(got, want)
        assert want[1] > 0 and want[2] < BATCH  # errors planted, not all


@pytest.mark.parametrize("case", ["judged", "nrlike", "crc24", "pivot"])
def test_batch_path_pinned(case):
    """On the CPU BatchFn runs its PyTorch ops; the kernels' tables build
    for every encoder and mode (on the card BatchFn takes them for all:
    chip_smoke.py checks that it did)."""
    fn = _batch_fn(case)
    assert fn.kernels is None
    kern = _kernels(fn)
    assert (kern.pos is None) == (kern.info_cols is None) == (
        fn.info_cols is None)
    assert (kern.tx_mask is None) == (case not in ("nrlike",))
    assert kern.kp == fn.kp and kern.n == fn.n and kern.k == fn.k_info
    kwp, mp = mc_batch.table_dims(fn.k_info, fn.n - fn.k_info)
    assert tuple(kern.table.shape) == (kwp, mp)
    assert kwp % 4 == 0 and mp % 32 == 0


def test_launch_counters_stay_zero_on_cpu():
    mc_batch.reset_launches()
    res = run_ber(_judged(), [3.0], CFG, batch=8, max_frames=16,
                  device="cpu")
    assert res[0].frames == 16
    assert mc_batch.LAUNCHES == {"mc_encode_llr": 0, "mc_count": 0}


def test_kernels_refuse_cpu_tensors():
    fn = _batch_fn("judged")
    kern = _kernels(fn)
    u, noise = _inputs(fn, 5)
    with pytest.raises(ValueError, match="on the card"):
        kern.encode_llr(u, noise, 2.0, fn.rate)
    with pytest.raises(ValueError, match="on the card"):
        kern.count(torch.zeros((BATCH, fn.n), dtype=torch.uint8), u,
                   torch.ones(BATCH, dtype=torch.bool),
                   torch.zeros(BATCH, dtype=torch.int32),
                   torch.zeros(6, dtype=torch.int64))


def test_pack_parity_table_layout():
    """Word w of column r holds M[r, 32w + b] at bit b."""
    M = np.random.default_rng(6).integers(0, 2, (37, 70)).astype(np.uint8)
    t = mc_batch.pack_parity_table(M)
    assert t.shape == mc_batch.table_dims(70, 37) == (4, 64)
    for r in (0, 17, 36):
        for i in (0, 31, 32, 69):
            assert (int(t[i // 32, r]) >> (i % 32)) & 1 == M[r, i]
    assert not t[:, 37:].any() and not t[3].any()
