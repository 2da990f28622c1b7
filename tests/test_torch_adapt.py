"""Port rate adaptation, BSC and the adapted / CRC-gated MC counters vs
the JAX package.

RateAdapt is a NumPy copy: dims, rate, masks and every error must equal
the JAX package's.  The adapted LLRs must equal the JAX package's
(2/sigma^2) * y * tx_mask + known_llr on the same noise bit for bit,
+0.0 at punctured positions included.  The counters of BatchFn with
puncturing, shortening and an outer CRC are compared on injected u and
noise with a composition of the JAX package's encoder, channel, jnp
reference decoder, CRC checker and counter lines
(tpu_ldpc/sim/mc.py::build_batch_fn), as test_torch_mc.py does without
adaptation.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.channel.adapt import RateAdapt as JaxRateAdapt
from tpu_ldpc.channel.awgn import bpsk as jax_bpsk
from tpu_ldpc.channel.awgn import noise_sigma2 as jax_noise_sigma2
from tpu_ldpc.channel.bsc import bsc_llr_magnitude as jax_bsc_magnitude
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes.crc import attach as jax_attach
from tpu_ldpc.codes.crc import make_crc_checker as jax_crc_checker
from tpu_ldpc.codes.nrlike import nrlike_code as jax_nrlike_code
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.encode.encoder import build_encoder as jax_build_encoder
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.channel import (
    RateAdapt, adapted_awgn_llrs, adapted_llrs_from_noise,
    bsc_llr_magnitude, bsc_llrs, bsc_llrs_from_flips)
from tpu_ldpc_torch.channel.adapt import SHORT_LLR
from tpu_ldpc_torch.codes.nrlike import nrlike_adapt
from tpu_ldpc_torch.sim.mc import (
    COUNTER_FIELDS, DecodeCfg, build_batch_fn, run_ber)

torch.set_num_threads(1)


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def jax_twin(code):
    return JaxLdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)


def judged():
    return twin(JaxLdpcCode.judged())


def nr34():
    return twin(jax_nrlike_code("3/4", 16))


def test_short_llr():
    from tpu_ldpc.channel.adapt import SHORT_LLR as JAX_SHORT_LLR

    assert SHORT_LLR == JAX_SHORT_LLR


@pytest.mark.parametrize("puncture,shorten", [
    ((15,), ()), ((), (0,)), ((14, 15), (0,)), ((15,), (1,)),
    ((0, 1), ()), ((), (2, 5, 7))])
def test_rate_adapt_equals_jax(puncture, shorten):
    code = judged()
    a = RateAdapt.from_blocks(code, puncture_blocks=puncture,
                              shorten_blocks=shorten)
    ja = JaxRateAdapt.from_blocks(jax_twin(code), puncture_blocks=puncture,
                                  shorten_blocks=shorten)
    assert (a.puncture, a.shorten) == (ja.puncture, ja.shorten)
    assert a.dims(code.n, code.k) == ja.dims(code.n, code.k)
    assert a.rate(code.n, code.k) == ja.rate(code.n, code.k)
    info_cols = np.arange(code.n - code.k, code.n)  # info bits at the tail
    for cols in (None, info_cols):
        if cols is not None and puncture and np.intersect1d(
                [p // code.Z for p in a.puncture], [8 + s for s in shorten]
        ).size:
            continue
        for got, want in zip(a.masks(code.n, code.k, cols),
                             ja.masks(code.n, code.k, cols)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    "shorten parity", "puncture range", "overlap", "rate >= 1",
    "shorten all", "mask puncture range", "mask shorten range",
    "mask overlap"])
def test_rate_adapt_errors_equal_jax(case):
    code = judged()

    def call(cls, c):
        if case == "shorten parity":
            cls.from_blocks(c, shorten_blocks=(8,))
        elif case == "puncture range":
            cls.from_blocks(c, puncture_blocks=(16,))
        elif case == "overlap":
            cls.from_blocks(c, puncture_blocks=(3,), shorten_blocks=(3,))
        elif case == "rate >= 1":
            cls.from_blocks(c, puncture_blocks=tuple(range(8, 16))).dims(
                c.n, c.k)
        elif case == "shorten all":
            cls.from_blocks(c, shorten_blocks=tuple(range(8))).dims(c.n, c.k)
        elif case == "mask puncture range":
            cls(puncture=(c.n,)).masks(c.n, c.k)
        elif case == "mask shorten range":
            cls(shorten=(c.k,)).masks(c.n, c.k)
        else:
            cls(puncture=(c.n - 1,), shorten=(c.k - 1,)).masks(
                c.n, c.k, np.arange(c.n - c.k, c.n))

    with pytest.raises(ValueError) as want:
        call(JaxRateAdapt, jax_twin(code))
    with pytest.raises(ValueError) as got:
        call(RateAdapt, code)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ebn0_db,rate", [
    (2.0, 0.5), (-1.5, 2 / 3), (4.25, 5 / 6), (1.0, 0.2)])
def test_adapted_llrs_bit_exact(ebn0_db, rate):
    rng = np.random.default_rng(8)
    n = 96
    c = rng.integers(0, 2, (32, n)).astype(np.uint8)
    noise = rng.normal(size=c.shape).astype(np.float32)
    tx = np.ones(n, np.float32)
    tx[:16] = tx[40:48] = 0.0
    known = np.zeros(n, np.float32)
    known[40:48] = SHORT_LLR
    sigma2 = jnp.float32(jax_noise_sigma2(ebn0_db, rate))
    y = jax_bpsk(c) + jnp.sqrt(sigma2) * noise
    want = np.asarray((2.0 / sigma2) * y * tx + known)
    got = adapted_llrs_from_noise(
        torch.from_numpy(c), torch.from_numpy(noise), ebn0_db, rate,
        torch.from_numpy(tx), torch.from_numpy(known)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[:, :16] == 0).all() and not np.signbit(got[:, :16]).any()
    assert (got[:, 40:48] == SHORT_LLR).all()
    # the generator-taking wrapper draws the same noise as randn
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    drawn = adapted_awgn_llrs(torch.from_numpy(c), ebn0_db, rate,
                              torch.from_numpy(tx), torch.from_numpy(known),
                              g1)
    again = adapted_llrs_from_noise(
        torch.from_numpy(c), torch.randn(c.shape, generator=g2), ebn0_db,
        rate, torch.from_numpy(tx), torch.from_numpy(known))
    assert torch.equal(drawn, again)


@functools.lru_cache(maxsize=4)
def jnp_decoder(code, cfg):
    """One jitted jnp decoder per code and cfg (compiling takes ~10 s)."""
    return jnp_build_decoder(jax_twin(code), cfg.algo, cfg.iters, cfg.alpha,
                             cfg.beta, cfg.schedule)


def jax_counters(code, cfg, u, noise, ebn0_db, adapt=None, crc=None):
    """The JAX package's per-batch counting with rate adaptation and an
    outer CRC (tpu_ldpc/sim/mc.py:132-231) on given u and noise."""
    jc = jax_twin(code)
    k, n = jc.k, jc.n
    if adapt is not None:
        ja = JaxRateAdapt(puncture=adapt.puncture, shorten=adapt.shorten)
        k_eff, n_tx = ja.dims(n, k)
        tx, known, active = (jnp.asarray(a) for a in ja.masks(n, k))
        u = u * active
    else:
        k_eff, n_tx = k, n
    if crc is not None:
        width = {"crc8": 8, "crc16": 16, "crc24": 24}[crc]
        k_eff -= width
    rate = k_eff / n_tx
    c = jax_build_encoder(jc, "generator")(u)
    sigma2 = jnp.float32(jax_noise_sigma2(ebn0_db, rate))
    llr = (2.0 / sigma2) * (jax_bpsk(c) + jnp.sqrt(sigma2) * noise)
    if adapt is not None:
        llr = llr * tx + known
    bits, ok, iters_used = jnp_decoder(code, cfg)(llr)
    info = bits[:, :k]
    wrong = info != u
    if adapt is not None:
        wrong = wrong & (active == 1)
    if crc is not None:
        wrong = wrong[:, :k - width]
        passed = jax_crc_checker(k, crc)(info)
    else:
        passed = ok
    frame_wrong = jnp.any(wrong, axis=1)
    return np.asarray([
        u.shape[0], jnp.sum(wrong), jnp.sum(frame_wrong), jnp.sum(~passed),
        jnp.sum(passed & frame_wrong), jnp.sum(iters_used)], dtype=np.int64)


@pytest.mark.parametrize("case", ["puncture", "shorten", "puncture_crc16"])
def test_batch_counters_match_jax(case):
    rng = np.random.default_rng(23)
    if case == "shorten":
        code, batch, ebn0_db = judged(), 24, 1.25
        adapt = RateAdapt.from_blocks(code, puncture_blocks=(15,),
                                      shorten_blocks=(0, 3))
    else:
        code, batch, ebn0_db = nr34(), 64, 2.0
        adapt = nrlike_adapt(code)
    crc = "crc16" if case.endswith("crc16") else None
    cfg = DecodeCfg(iters=20)
    fn = build_batch_fn(code, cfg, batch, adapt, crc, device="cpu")
    k_eff, n_tx = adapt.dims(code.n, code.k)
    assert fn.k == k_eff - (16 if crc else 0)
    assert fn.rate == fn.k / n_tx
    if crc:
        u = jax_attach(rng.integers(0, 2, (batch, code.k - 16)).astype(
            np.uint8), crc)
    else:
        u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    noise = rng.normal(size=(batch, code.n)).astype(np.float32)
    got = fn.batch_counters(torch.from_numpy(u), torch.from_numpy(noise),
                            ebn0_db)
    assert got.dtype == torch.int64 and got.shape == (len(COUNTER_FIELDS),)
    want = jax_counters(code, cfg, u, noise, ebn0_db, adapt, crc)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[2] > 0 and want[3] > 0  # errors were counted


def test_draw_attaches_crc_and_zeroes_nothing_else():
    code = nr34()
    fn = build_batch_fn(code, DecodeCfg(iters=5), 16, nrlike_adapt(code),
                        "crc16", device="cpu")
    u, noise = fn.draw(torch.Generator().manual_seed(1))
    assert u.shape == (16, code.k) and noise.shape == (16, code.n)
    np.testing.assert_array_equal(
        u.numpy(), jax_attach(u.numpy()[:, :code.k - 16], "crc16"))
    plain = build_batch_fn(code, DecodeCfg(iters=5), 16, device="cpu")
    u0, noise0 = plain.draw(torch.Generator().manual_seed(1))
    # no adaptation, no CRC: u of k bits, then the noise (the old draw)
    g = torch.Generator().manual_seed(1)
    assert torch.equal(u0, torch.randint(0, 2, (16, code.k), generator=g,
                                         dtype=torch.uint8))
    assert torch.equal(noise0, torch.randn((16, code.n), generator=g))


def test_crc_with_shortening_raises():
    code = judged()
    adapt = RateAdapt.from_blocks(code, shorten_blocks=(0,))
    with pytest.raises(ValueError, match="crc \\+ shortening"):
        build_batch_fn(code, DecodeCfg(iters=5), 8, adapt, "crc16",
                       device="cpu")
    with pytest.raises(ValueError, match="crc \\+ shortening"):
        run_ber(code, [2.0], DecodeCfg(iters=5), batch=8, max_frames=8,
                adapt=adapt, crc="crc16", device="cpu")
    # puncturing composes with a CRC
    run_ber(code, [2.0], DecodeCfg(iters=5), batch=8, max_frames=8,
            adapt=RateAdapt.from_blocks(code, puncture_blocks=(15,)),
            crc="crc16", device="cpu")


@pytest.mark.parametrize("p", [1e-3, 0.01, 0.1, 0.3, 0.49])
def test_bsc_equals_jax(p):
    assert bsc_llr_magnitude(p) == jax_bsc_magnitude(p)
    rng = np.random.default_rng(9)
    c = rng.integers(0, 2, (16, 64)).astype(np.uint8)
    flips = rng.random(c.shape) < p
    y = jnp.asarray(c).astype(jnp.int32) ^ jnp.asarray(flips).astype(
        jnp.int32)
    want = np.asarray((1.0 - 2.0 * y.astype(jnp.float32))
                      * jax_bsc_magnitude(p))
    got = bsc_llrs_from_flips(torch.from_numpy(c), torch.from_numpy(flips),
                              p).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    drawn = bsc_llrs(torch.from_numpy(c), p,
                     torch.Generator().manual_seed(4))
    flipped = (drawn.numpy() < 0) != (c == 1)
    assert abs(flipped.mean() - p) < 4 * np.sqrt(p * (1 - p) / c.size) + 1e-3


@pytest.mark.parametrize("p", [0.0, 0.5, -0.1, 0.7])
def test_bsc_errors_equal_jax(p):
    with pytest.raises(ValueError) as want:
        jax_bsc_magnitude(p)
    with pytest.raises(ValueError) as got:
        bsc_llrs(torch.zeros((2, 4), dtype=torch.uint8), p,
                 torch.Generator())
    assert str(got.value) == str(want.value)
