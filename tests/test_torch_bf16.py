"""bf16 message storage in the port (the plain decoder's
msg_dtype=torch.bfloat16: the oracle of the K7 kernels) vs the JAX
package's Pallas kernel with msg_dtype=jnp.bfloat16, in interpret mode as
tests/test_pallas.py runs it.

R is rounded to bf16 (nearest even) where it is stored and computed in
float32.  Min-sum and sumproduct-fast must agree bit for bit with Pallas
on both schedules -- in the layered schedule only that catches a posterior
update that takes the rounded message instead of the unrounded one.
Exact sum-product meets the >= 0.97 frame contract, and bf16 agrees with
float32 on >= 0.97 of frames (test_pallas.py::test_bf16_message_mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)
BF16 = torch.bfloat16


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


def numpy_of(out):
    return [np.asarray(x) for x in out]


def agreement(got, want):
    """min(share of frames with equal bits, share with equal ok): the
    JAX package's frame contract (test_pallas.py::test_bf16_message_mode)."""
    (gb, gok, _), (wb, wok, _) = numpy_of(got), numpy_of(want)
    return min((gb == wb).all(axis=1).mean(), (gok == wok).mean())


def assert_same(got, want, what):
    for name, g, w in zip(("bits", "ok", "iters_used"), numpy_of(got),
                          numpy_of(want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def test_bf16_rounding_is_round_to_nearest_even_as_xla():
    """The store's rounding equals XLA's astype(bfloat16) on ties,
    subnormals, signed zeros and large values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(scale=20.0, size=4096),
        [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 0.0, -0.0,
         1e-40, -3e-39, 3.4e38, 255.5, 256.5, 1e4, -3e4]]).astype(np.float32)
    got = torch.from_numpy(x).to(BF16).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("algo", ["minsum", "sumproduct-fast"])
def test_bf16_bitexact_vs_pallas(algo, schedule):
    ref, code = toy_codes()
    llr = noisy_llrs(ref, 40, 2.5, seed=31)
    for early_stop in (True, False) if algo == "minsum" else (True,):
        args = (algo, 12, 0.75, 0.0, schedule, early_stop)
        got = build_decoder(code, *args, msg_dtype=BF16)(
            torch.from_numpy(llr))
        pallas = build_pallas_decoder(ref, *args, normalize=False,
                                      msg_dtype=jnp.bfloat16, interpret=True)
        assert_same(got, pallas(llr), f"early_stop={early_stop}")
        # the normalized plain decoder (the CUDA builder's CPU path) too
        on = build_cuda_decoder(code, *args, msg_dtype=BF16)(
            torch.from_numpy(llr))
        assert_same(on, got, f"normalized early_stop={early_stop}")
        f32 = build_decoder(code, *args)(torch.from_numpy(llr))
        assert agreement(got, f32) >= 0.97
        assert 0 < got[1].float().mean() < 1


def test_bf16_messages_really_round():
    """The stored messages are bf16 values and differ from float32's."""
    _, code = toy_codes()
    llr = torch.from_numpy(noisy_llrs(code, 40, 2.5, seed=32))
    for schedule in ("flooding", "layered"):
        P16 = build_decoder(code, iters=6, schedule=schedule,
                            early_stop=False, msg_dtype=BF16).posterior(llr)[0]
        P32 = build_decoder(code, iters=6, schedule=schedule,
                            early_stop=False).posterior(llr)[0]
        assert not torch.equal(P16, P32)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_bf16_sumproduct_frame_contract(schedule):
    """Exact sum-product with bf16 messages: >= 0.97 of frames with Pallas
    bf16 (transcendentals round differently) and with float32."""
    ref, code = toy_codes()
    llr = noisy_llrs(ref, 128, 2.5, seed=33)
    args = ("sumproduct", 12, 0.75, 0.0, schedule, True)
    got = build_decoder(code, *args, msg_dtype=BF16)(torch.from_numpy(llr))
    pallas = build_pallas_decoder(ref, *args, normalize=False,
                                  msg_dtype=jnp.bfloat16, interpret=True)
    assert agreement(got, pallas(llr)) >= 0.97
    f32 = build_decoder(code, *args)(torch.from_numpy(llr))
    assert agreement(got, f32) >= 0.97


def test_bf16_refusals():
    """As the JAX builder: quantization or compressed state with bf16
    raise NotImplementedError, rescaled with bf16 ValueError; a message
    type other than float32 / bf16 is refused."""
    _, code = toy_codes()
    for builder in (build_decoder, build_cuda_decoder):
        with pytest.raises(NotImplementedError, match="quant"):
            builder(code, quant_bits=6, msg_dtype=BF16)
        with pytest.raises(NotImplementedError, match="compressed"):
            builder(code, compressed=True, msg_dtype=BF16)
        with pytest.raises(ValueError, match="rescaled"):
            builder(code, rescaled=True, msg_dtype=BF16)
        with pytest.raises(ValueError, match="msg_dtype"):
            builder(code, msg_dtype=torch.float16)
    # float32 is the default storage
    llr = torch.from_numpy(noisy_llrs(code, 8, 2.5, seed=34))
    assert_same(build_decoder(code, msg_dtype=torch.float32)(llr),
                build_decoder(code)(llr), "float32")
