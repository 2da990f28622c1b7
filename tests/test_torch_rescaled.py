"""Rescaled min-sum in the port (the plain decoder's rescaled=True: the
oracle of the K8 kernel) vs the JAX package, mirroring the rescaled tests
of tests/test_pallas.py.

The CN runs with alpha 1 and the channel term is multiplied by
fp32(1)/fp32(alpha) once per iteration (golden/decoder.py, rescaled=True):
bits, ok and iters_used bit-exact with golden float32 rescaled and with
the Pallas kernel in interpret mode, ET on and off, up to the contract's
200 iterations on adversarial LLRs; the refusals of the JAX builder.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
from tpu_ldpc_torch.decode.reference import build_decoder

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


def assert_same(got, want, what=""):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what} {name}")


def port(code, llr, **kw):
    fn = build_decoder(code, "minsum", rescaled=True, **kw)
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


@pytest.mark.parametrize("early_stop", [True, False])
def test_rescaled_bitexact_vs_golden_and_pallas(early_stop):
    ref, code = toy_codes()
    llr = noisy_llrs(ref, 40, 3.0, seed=5)
    kw = dict(iters=17, alpha=0.75, early_stop=early_stop)
    got = port(code, llr, **kw)
    assert_same(got, golden_decode(ref.H, llr, algo="minsum",
                                   dtype=np.float32, rescaled=True, **kw),
                "golden")
    pallas = build_pallas_decoder(ref, "minsum", rescaled=True,
                                  interpret=True, **kw)
    assert_same(got, pallas(llr), "Pallas")
    # the normalized plain decoder (the CUDA builder's CPU path) too
    on = build_cuda_decoder(code, "minsum", rescaled=True, **kw)(
        torch.from_numpy(llr))
    assert_same(got, [x.numpy() for x in on], "normalized")
    # rounding apart, the standard contract on this batch
    std = build_decoder(code, "minsum", **kw)(torch.from_numpy(llr))
    assert (got[0] == std[0].numpy()).all(axis=1).mean() >= 0.97
    assert (got[1] == std[1].numpy()).mean() >= 0.97
    assert 0 < got[1].mean() < 1


def test_rescaled_judged_code_bitexact_vs_golden():
    """The judged code through 50 rescaled iterations, ET off and on."""
    ref = JaxLdpcCode.judged()
    code = LdpcCode.judged()
    llr = noisy_llrs(ref, 6, 2.0, seed=17)
    for early_stop in (False, True):
        kw = dict(iters=50, alpha=0.75, early_stop=early_stop)
        assert_same(port(code, llr, **kw),
                    golden_decode(ref.H, llr, algo="minsum",
                                  dtype=np.float32, rescaled=True, **kw),
                    f"early_stop={early_stop}")


def test_rescaled_extreme_magnitude_stress():
    """Magnitudes grow as alpha^-k (~1e15 at 120 iterations): large finite
    LLRs through 120 iterations stay bit-exact with golden and Pallas, and
    the posterior stays finite."""
    ref, code = toy_codes()
    rng = np.random.default_rng(3)
    llr = (rng.choice([-60.0, -1e-3, 1e-3, 60.0], size=(16, code.n))
           * rng.uniform(0.5, 1.0, size=(16, code.n))).astype(np.float32)
    kw = dict(iters=120, alpha=0.75, early_stop=True)
    got = port(code, llr, **kw)
    assert_same(got, golden_decode(ref.H, llr, algo="minsum",
                                   dtype=np.float32, rescaled=True, **kw),
                "golden")
    pallas = build_pallas_decoder(ref, "minsum", rescaled=True,
                                  interpret=True, **kw)
    assert_same(got, pallas(llr), "Pallas")
    P, _, _ = build_decoder(code, "minsum", iters=120, early_stop=False,
                            rescaled=True).posterior(torch.from_numpy(llr))
    assert torch.isfinite(P).all() and P.abs().max() > 1e10


@pytest.mark.parametrize("kw", [
    dict(algo="sumproduct"), dict(algo="sumproduct-fast"),
    dict(schedule="layered"), dict(beta=0.1), dict(compressed=True),
    dict(quant_bits=6), dict(iters=300), dict(msg_dtype=torch.bfloat16)],
    ids=["sumproduct", "sumproduct-fast", "layered", "beta", "compressed",
         "quant", "iters", "bf16"])
def test_rescaled_rejects_unsupported(kw):
    """The rescaled contract is flooding min-sum, beta=0, float messages,
    no quantization, iters <= 200: ValueError, as the JAX builder."""
    ref, code = toy_codes()
    kw = {"iters": 10, **kw}
    with pytest.raises(ValueError, match="rescaled"):
        build_decoder(code, rescaled=True, **kw)
    with pytest.raises(ValueError, match="rescaled"):
        build_cuda_decoder(code, rescaled=True, **kw)
    if "msg_dtype" in kw:
        import jax.numpy as jnp

        kw["msg_dtype"] = jnp.bfloat16
    with pytest.raises(ValueError, match="rescaled"):
        build_pallas_decoder(ref, rescaled=True, interpret=True, **kw)
