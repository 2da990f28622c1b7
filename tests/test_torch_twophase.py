"""Two-phase decoding and its knobs (decode/twophase.py, decode/knobs.py)
vs single-pass early termination and the JAX package.

Two-phase output must be bit-identical to the single-pass ET decoder
(bits, ok, iters_used): in the compacted case, in the full-batch fallback
and with a phase-1 budget K above `iters` (clamped).  On the toy code it
must also equal the JAX package's two-phase decoder with the Pallas
kernel in interpret mode.
"""

import warnings

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.knobs import registry_entry as jax_registry_entry
from tpu_ldpc.decode.knobs import resolve_twophase_knobs as jax_resolve
from tpu_ldpc.decode.twophase import (
    build_twophase_decoder as jax_build_twophase_decoder)
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes import base_graphs
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.knobs import registry_entry, resolve_twophase_knobs
from tpu_ldpc_torch.decode.reference import build_decoder
from tpu_ldpc_torch.decode.twophase import (
    build_twophase_decoder, tune_phase1_iters)

torch.set_num_threads(1)


def toy_codes(Z=8):
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, Z, seed=7), Z,
                                      f"toy{Z}")
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), Z, ref.name)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def as_numpy(out):
    return [np.asarray(x) for x in out]


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), as_numpy(got),
                          as_numpy(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("algo", ["minsum", "sumproduct"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_twophase_bit_identical_to_single_pass(schedule, algo):
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 64, 2.0, seed=41))
    single = build_decoder(code, algo, 20, schedule=schedule)(llr)
    fn = build_twophase_decoder(code, 20, 4, 32, report_fallback=True,
                                algo=algo, schedule=schedule)
    *got, n_unconv = fn(llr)
    assert 0 < n_unconv <= 32  # the compacted path ran
    assert_same(got, single)
    assert 0 < single[1].float().mean() < 1


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_twophase_overflow_falls_back_to_the_full_batch(schedule):
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 64, 1.0, seed=42))
    single = build_decoder(code, "minsum", 20, schedule=schedule)(llr)
    fn = build_twophase_decoder(code, 20, 2, 4, report_fallback=True,
                                warn_on_fallback=True, schedule=schedule)
    with pytest.warns(UserWarning, match="overflowed"):
        *got, n_unconv = fn(llr)
    assert n_unconv > 4
    assert_same(got, single)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warns once per decoder
        fn(llr)


def test_twophase_k_above_iters_is_clamped():
    """K > iters must not let phase 1 report lanes converging after
    `iters` (single-pass ET reports them as failed)."""
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 64, 2.0, seed=43))
    single = build_decoder(code, "minsum", 3, schedule="layered")(llr)
    got = build_twophase_decoder(code, 3, 16, 8, schedule="layered")(llr)
    assert_same(got, single)
    assert (single[2] <= 3).all()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_twophase_equals_jax_interpret(schedule):
    ref, code = toy_codes()
    llr = noisy_llrs(code, 128, 2.0, seed=44)
    jfn = jax_build_twophase_decoder(ref, 20, 4, 128, interpret=True,
                                     report_fallback=True, algo="minsum",
                                     schedule=schedule)
    *want, jn = jfn(llr)
    *got, n = build_twophase_decoder(code, 20, 4, 128, report_fallback=True,
                                     schedule=schedule)(torch.from_numpy(llr))
    assert n == int(jn) > 0
    assert_same(got, want)


def test_twophase_through_decode():
    """decode(impl='twophase'): explicit knobs, and knobs resolved from the
    rate (the toy code has no table entry), warn-on-overflow included."""
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 64, 2.0, seed=45))
    single = decode(code, llr, schedule="layered", iters=20)
    got = decode(code, llr, schedule="layered", iters=20, impl="twophase",
                 phase1_iters=3, compact_budget=16)
    assert_same(got, single)
    got = decode(code, llr, schedule="layered", iters=20, impl="twophase")
    assert_same(got, single)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_twophase_phase1_alpha_runs(schedule):
    """The experimental hybrid: phase 1 at another alpha (not bit-identical
    to single-pass ET by design) equals the JAX package's hybrid."""
    ref, code = toy_codes()
    llr = noisy_llrs(code, 64, 2.5, seed=46)
    *want, jn = jax_build_twophase_decoder(
        ref, 20, 4, 32, interpret=True, report_fallback=True,
        phase1_alpha=1.0, algo="minsum", schedule=schedule)(llr)
    *got, n = build_twophase_decoder(
        code, 20, 4, 32, report_fallback=True, phase1_alpha=1.0,
        schedule=schedule)(torch.from_numpy(llr))
    assert n == int(jn)
    assert_same(got, want)
    assert got[0].shape == (64, code.n) and got[1].float().mean() > 0.5


REGISTRY = [None] + [
    (family, rate, Z)
    for family, lifts in sorted(base_graphs.FAMILY_LIFTS.items())
    for rate in sorted(base_graphs._RATE_SHAPES) for Z in lifts]


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_knobs_equal_jax_for_every_registry_cell(schedule):
    """The judged code and the 24 family cells, table and derived knobs,
    with and without explicit values."""
    assert len(REGISTRY) == 25
    for cell in REGISTRY:
        code = LdpcCode.judged() if cell is None else LdpcCode.from_family(*cell)
        ref = (JaxLdpcCode.judged() if cell is None
               else JaxLdpcCode.from_family(*cell))
        assert code.name == ref.name
        for k, b in ((None, None), (5, None), (None, 100), (7, 200)):
            assert resolve_twophase_knobs(code, schedule, k, b) == \
                jax_resolve(ref, schedule, k, b), (code.name, k, b)
        assert registry_entry(code, schedule) == \
            jax_registry_entry(ref, schedule)


def test_knobs_judged_layered_from_the_table():
    k, b, source = resolve_twophase_knobs(LdpcCode.judged(), "layered",
                                          None, None)
    assert (k, b, source) == (9, 768, "registry")
    _, toy = toy_codes()
    assert resolve_twophase_knobs(toy, "layered", None, None)[2] == "derived"


def test_tune_phase1_iters_picks_from_the_measured_curve():
    _, code = toy_codes()
    K, budget, stats = tune_phase1_iters(code, 2.0, batch=256, iters=20,
                                         seed=3, device="cpu",
                                         schedule="layered")
    assert 1 <= K <= 20 and budget % 128 == 0 and 128 <= budget <= 256
    assert stats["K"] == K and stats["budget"] == budget
    assert 0 <= stats["frac_unconverged"] < 0.5
    assert 0 < stats["mean_iters"] < 20
    again = tune_phase1_iters(code, 2.0, batch=256, iters=20, seed=3,
                              device="cpu", schedule="layered")
    assert again == (K, budget, stats)  # the generator is seeded
