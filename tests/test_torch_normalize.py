"""Shift normalization in the port (decode/normalize.py, and the plain
decoder's normalize=True: the oracle of the K9 kernels) vs the JAX package.

The port's copy of the offset search must pick the JAX package's offsets
on every code, and decoding in the rotated coordinates must be a pure
relabeling: bits, ok and iters_used bit-identical to the unrotated plain
decoder and to the Pallas kernel in interpret mode (normalize on and off),
as tests/test_pallas.py runs it.  The port decodes its own LdpcCode, built
from the JAX package's through LdpcCode.from_base_graph.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph, make_sc_base_graph
from tpu_ldpc.decode.pallas_bp import _normalize_offsets, build_pallas_decoder
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes import base_graphs
from tpu_ldpc_torch.decode.normalize import coordinates, normalize_offsets
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)

REGISTRY = [(family, rate, Z)
            for family, lifts in sorted(base_graphs.FAMILY_LIFTS.items())
            for rate in sorted(base_graphs._RATE_SHAPES)
            for Z in lifts]


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def toy_codes(Z=8):
    ref = JaxLdpcCode.from_base_graph(make_base_graph(4, 8, Z, seed=7), Z,
                                      f"toy{Z}")
    return ref, twin(ref)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def zero_shift_edges(code, normalize):
    return sum(s == 0 for s in coordinates(code, normalize)[0])


@pytest.mark.parametrize("family,rate,Z", REGISTRY,
                         ids=[f"{f}-{r}-{z}" for f, r, z in REGISTRY])
def test_offsets_equal_jax_on_registry(family, rate, Z):
    ref = JaxLdpcCode.from_family(family, rate, Z)
    port = LdpcCode.from_family(family, rate, Z)
    assert normalize_offsets(port.layout) == _normalize_offsets(ref.layout)
    assert zero_shift_edges(port, True) >= zero_shift_edges(port, False)


def test_offsets_equal_jax_on_judged_toy_and_sc():
    sc = make_sc_base_graph(8, 8, seed=5)
    refs = [JaxLdpcCode.judged(), toy_codes(8)[0], toy_codes(16)[0],
            JaxLdpcCode.from_base_graph(sc, 8, "sc8k")]
    for ref in refs:
        port = twin(ref)
        assert normalize_offsets(port.layout) == _normalize_offsets(
            ref.layout), ref.name
    # the zero-shift edges the search gains (of 51, 81 and 71 edges)
    for code, before, after in (
            (LdpcCode.judged(), 15, 24),
            (LdpcCode.from_family("wifi", "2/3", 27), 19, 34),
            (LdpcCode.from_family("wimax", "5/6", 96), 8, 27)):
        assert zero_shift_edges(code, False) == before
        assert zero_shift_edges(code, True) == after


def assert_same(got, want, what):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_normalized_decode_bitexact(schedule, early_stop):
    """min-sum, sumproduct-fast and 6-bit min-sum: normalize=True ==
    normalize=False, and == Pallas normalize=True (with ET off, where the
    latched-bit merge does not run, for min-sum only: each interpret-mode
    build costs seconds); flooding min-sum with ET on also == Pallas
    normalize=False."""
    ref, code = toy_codes()
    assert any(coordinates(code, True)[1])  # the columns really rotate
    llr = noisy_llrs(ref, 24, 2.5, seed=11)
    for algo, kw in (("minsum", {}), ("sumproduct-fast", {}),
                     ("minsum", dict(quant_bits=6, quant_step=0.25))):
        args = (algo, 10, 0.75, 0.0, schedule, early_stop)
        off = build_decoder(code, *args, **kw)(torch.from_numpy(llr))
        on = build_decoder(code, *args, **kw, normalize=True)(
            torch.from_numpy(llr))
        what = f"{algo} {kw}"
        assert_same(on, off, what)
        assert 0 < on[1].float().mean() < 1
        if early_stop or (algo == "minsum" and not kw):
            pallas = build_pallas_decoder(ref, *args, normalize=True,
                                          interpret=True, **kw)
            assert_same(on, pallas(llr), f"{what} vs Pallas")
        if early_stop and schedule == "flooding" and algo == "minsum" \
                and not kw:
            pallas = build_pallas_decoder(ref, *args, normalize=False,
                                          interpret=True)
            assert_same(on, pallas(llr), f"{what} vs Pallas unnormalized")


def test_normalized_posterior_is_unrotated():
    """posterior() returns P in the code's own coordinates."""
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 8, 2.5, seed=12))
    for schedule in ("flooding", "layered"):
        p_off = build_decoder(code, iters=6, schedule=schedule).posterior(llr)
        p_on = build_decoder(code, iters=6, schedule=schedule,
                             normalize=True).posterior(llr)
        for a, b in zip(p_off, p_on):
            assert torch.equal(a, b)
