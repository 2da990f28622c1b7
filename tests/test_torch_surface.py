"""The surface the port shares with the JAX package's timer, tuner and
plain decoders, held against the JAX package on inputs made from a seed:

- benchcore.make_timer's operating point (scale, sigma, the erased
  positions of a punctured code) and LoopTimer.measure_at;
- reference.decode and the plain decoders' arithmetic type (dtype):
  bf16 against the JAX reference's bf16, float32 bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.benchcore import make_timer as jax_make_timer
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.codes.base_graphs import make_sc_base_graph as jax_sc_graph
from tpu_ldpc.decode.reference import build_decoder as jax_build_decoder
from tpu_ldpc.decode.windowed import (
    build_windowed_decoder as jax_build_windowed_decoder)
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch import benchcore
from tpu_ldpc_torch.benchcore import make_timer
from tpu_ldpc_torch.decode import reference
from tpu_ldpc_torch.decode.reference import build_decoder
from tpu_ldpc_torch.decode.windowed import build_windowed_decoder

torch.set_num_threads(1)
MIN_AGREEMENT = 0.97  # the JAX package's bf16 / sum-product frame contract


def toy_codes(Z=8):
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, Z, seed=7), Z,
                                      f"toy{Z}")
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), Z, ref.name)


def noisy_llrs(code, batch, ebn0_db, seed):
    """Noisy all-zero codewords, NumPy from a seed."""
    rng = np.random.default_rng(seed)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = 1.0 + np.sqrt(sigma2) * rng.normal(size=(batch, code.n))
    return (2.0 / sigma2 * y).astype(np.float32)


def numpy_of(out):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor)
                       and x.dtype == torch.bfloat16 else x) for x in out]


def agreement(got, want):
    """Share of frames whose bits, ok and iters_used all agree."""
    gb, gok, giu = numpy_of(got)
    wb, wok, wiu = numpy_of(want)
    return float(((gb == wb).all(axis=1) & (gok == wok)
                  & (giu == wiu)).mean())


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), numpy_of(got),
                          numpy_of(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---- benchcore.make_timer / LoopTimer.measure_at ------------------------

@pytest.mark.parametrize("n_punct,rate", [(0, None), (128, None),
                                          (128, 0.4), (0, 0.6)])
def test_make_timer_point_equals_jax(n_punct, rate):
    ref, code = toy_codes(32)  # n = 256
    jt, _ = jax_make_timer(ref, 8, 1.7, inner=1, n_punct=n_punct, rate=rate)
    pt = make_timer(code, 8, 1.7, device="cpu", n_buffers=3, seed=5,
                    n_punct=n_punct, rate=rate)
    assert (pt.scale, pt.sig) == (jt.scale, jt.sig)
    assert isinstance(pt.scale, float) and isinstance(pt.sig, float)
    for x, noise, llr in zip(pt.xs, pt.noises, pt.llrs):
        assert set(torch.unique(x).tolist()) <= {-1.0, 1.0}
        want = pt.scale * (x + pt.sig * noise)
        want[:, :n_punct] = 0.0
        assert torch.equal(llr, want)
        erased = llr[:, :n_punct]
        assert (erased == 0).all() and not torch.signbit(erased).any()
        assert (llr[:, n_punct:] != 0).all()


def test_make_timer_unpunctured_keeps_its_llrs():
    """n_punct=0 and no rate: the LLRs of awgn_llrs's draw order (info
    bits, then the normal draw, from one generator) at code.rate."""
    from tpu_ldpc_torch.channel.awgn import noise_sigma2
    from tpu_ldpc_torch.encode.encoder import select_encoder

    _, code = toy_codes()
    pt = make_timer(code, 16, 2.5, device="cpu", n_buffers=2, seed=9)
    gen = torch.Generator().manual_seed(9)
    encode_fn, k, _ = select_encoder(code, device="cpu")
    sigma2 = noise_sigma2(2.5, code.rate)
    for llr in pt.llrs:
        u = torch.randint(0, 2, (16, k), generator=gen, dtype=torch.uint8)
        x = 1.0 - 2.0 * encode_fn(u).to(torch.float32)
        noise = torch.randn(x.shape, generator=gen)
        assert torch.equal(llr, (2.0 / sigma2) * (
            x + float(np.sqrt(sigma2)) * noise))


def test_measure_at_rebuilds_the_buffers():
    _, code = toy_codes(32)
    timer = make_timer(code, 8, 2.0, device="cpu", n_buffers=3, n_punct=64)
    seen = []

    def fn(llr):
        seen.append(llr)
        return llr.sum()

    m = timer.measure_at(fn, 3.25, 0.5, reps=2)
    assert set(m) == {"median_s", "best_s", "dec_ms"}
    assert len(m["dec_ms"]) == benchcore.REPEATS
    assert 0 < m["best_s"] <= m["median_s"]
    assert len(seen) == benchcore.WARMUP + benchcore.REPEATS * 2
    buffers = {id(t): t for t in seen}
    assert len(buffers) == 2  # reps 2: the first two buffers cycle
    for i, llr in enumerate(seen[:2]):
        want = 3.25 * (timer.xs[i] + 0.5 * timer.noises[i])
        want[:, :64] = 0.0
        assert torch.equal(llr, want)
        assert not any(llr is own for own in timer.llrs)
    # the same point reuses the rebuilt buffers; measure keeps its own
    seen.clear()
    timer.measure_at(fn, 3.25, 0.5, reps=2)
    assert {id(t) for t in seen} == set(buffers)
    seen.clear()
    timer.measure(fn, reps=3)
    first_run = seen[benchcore.WARMUP:benchcore.WARMUP + 3]
    assert [id(t) for t in first_run] == [id(t) for t in timer.llrs]
    # the timer's own point rebuilds its own LLRs exactly
    seen.clear()
    timer.measure_at(fn, timer.scale, timer.sig, reps=3)
    first_run = seen[benchcore.WARMUP:benchcore.WARMUP + 3]
    assert len(first_run) == len(timer.llrs) == 3
    for llr, own in zip(first_run, timer.llrs):
        assert torch.equal(llr, own)
        assert llr is not own
    assert [id(t) for t in timer.buffers_at(timer.scale, timer.sig)] == [
        id(t) for t in first_run]


# ---- reference.decode and dtype -----------------------------------------

@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_reference_decode_equals_build_decoder(algo, schedule):
    _, code = toy_codes()
    llr = noisy_llrs(code, 48, 2.0, seed=61)
    kw = dict(algo=algo, iters=15, schedule=schedule)
    got = reference.decode(code, llr, **kw)
    assert_same(got, build_decoder(code, **kw)(torch.from_numpy(llr)))
    assert_same(reference.decode(code, torch.from_numpy(llr), **kw), got)


@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast", "sumproduct"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_bf16_dtype_agrees_with_jax(algo, schedule):
    ref, code = toy_codes(16)
    llr = noisy_llrs(code, 200, 2.0, seed=62)
    args = (algo, 12, 0.75, 0.0, schedule, True)
    port = build_decoder(code, *args, dtype=torch.bfloat16)
    got = port(torch.from_numpy(llr))
    want = jax_build_decoder(ref, *args, dtype=jnp.bfloat16)(llr)
    assert agreement(got, want) >= MIN_AGREEMENT
    assert 0 < float(got[1].float().mean()) < 1
    P, _, _ = port.posterior(torch.from_numpy(llr))
    assert P.dtype == torch.bfloat16  # computed in bf16, not float32


@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_float32_dtype_unchanged(algo, schedule, early_stop):
    """dtype=float32 is the default and bit for bit the JAX reference."""
    ref, code = toy_codes(16)
    llr = noisy_llrs(code, 64, 2.0, seed=63)
    args = (algo, 12, 0.75, 0.0, schedule, early_stop)
    default = build_decoder(code, *args)(torch.from_numpy(llr))
    explicit = build_decoder(code, *args, dtype=torch.float32)(
        torch.from_numpy(llr))
    assert_same(explicit, default)
    assert_same(default, jax_build_decoder(ref, *args)(llr))


def sc_codes(L=8, Z=8):
    ref = JaxLdpcCode.from_base_graph(jax_sc_graph(L, Z, seed=3), Z,
                                      f"sc_l{L}_z{Z}")
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), Z, ref.name)


@pytest.mark.parametrize("sweep", ["flooding", "layered"])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
def test_windowed_dtype_as_jax(sweep, algo):
    """bf16 agrees with JAX's bf16 windowed decoder on >= 0.97 of frames;
    float32 (the default) equals JAX's bit for bit."""
    ref, code = sc_codes()
    llr = noisy_llrs(code, 128, 2.5, seed=64)
    kw = dict(algo=algo, sweep=sweep)
    f32 = build_windowed_decoder(code, 4, 2, device="cpu", **kw)(
        torch.from_numpy(llr))
    explicit = build_windowed_decoder(code, 4, 2, device="cpu",
                                      dtype=torch.float32, **kw)(
        torch.from_numpy(llr))
    assert_same(explicit, f32)
    assert_same(f32, jax_build_windowed_decoder(ref, 4, 2, **kw)(llr))
    got = build_windowed_decoder(code, 4, 2, device="cpu",
                                 dtype=torch.bfloat16, **kw)(
        torch.from_numpy(llr))
    want = jax_build_windowed_decoder(ref, 4, 2, dtype=jnp.bfloat16,
                                      **kw)(llr)
    assert agreement(got, want) >= MIN_AGREEMENT
    assert 0 < float(got[1].float().mean()) < 1
