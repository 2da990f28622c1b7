"""Port encoder and channel vs the JAX package and the golden model.

The same NumPy inputs go through both packages: encoders must agree
exactly (GF(2)); LLRs to rtol 1e-6, because XLA on the CPU may contract
sqrt(sigma2) * noise + x into one fused multiply-add.  The port encodes
its own LdpcCode, built from the JAX package's through
LdpcCode.from_base_graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_ldpc.channel.awgn import bpsk as jax_bpsk
from tpu_ldpc.channel.awgn import noise_sigma2 as jax_noise_sigma2
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph, make_sc_base_graph
from tpu_ldpc.encode.encoder import build_encoder as jax_build_encoder
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.channel.awgn import (
    awgn_llrs, llrs_from_noise, noise_sigma2)
from tpu_ldpc_torch.encode.encoder import build_encoder, select_encoder

torch.set_num_threads(1)


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def jax_code(code):
    return JaxLdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)


def toy_code(Z=8):
    return twin(JaxLdpcCode.from_base_graph(
        make_base_graph(4, 8, Z, seed=7), Z, f"toy{Z}"))


def sc_code():
    return twin(JaxLdpcCode.from_base_graph(make_sc_base_graph(4, 8), 8,
                                            "sc_l4_z8"))


CODES = {
    "toy": toy_code,
    "wifi_z27": lambda: twin(JaxLdpcCode.from_family("wifi", "2/3", 27)),
    "judged": lambda: twin(JaxLdpcCode.judged()),
}


def _syndrome_zero(code, c):
    H = sp.csr_matrix(code.H).astype(np.int64)
    return not np.any((H @ c.astype(np.int64).T) % 2)


@pytest.mark.parametrize("name", sorted(CODES))
def test_generator_encoder_exact(name):
    code = CODES[name]()
    u = np.random.default_rng(3).integers(0, 2, (16, code.k)).astype(np.uint8)
    c = build_encoder(code, "generator", device="cpu")(torch.from_numpy(u))
    assert c.dtype == torch.uint8 and c.shape == (16, code.n)
    c = c.numpy()
    np.testing.assert_array_equal(
        c, np.asarray(jax_build_encoder(jax_code(code), "generator")(u)))
    np.testing.assert_array_equal(c, golden_encode(code.H, u))
    assert _syndrome_zero(code, c)


def test_pivot_encoder_matches_jax_on_sc_chain():
    code = sc_code()
    fn = build_encoder(code, "pivot", device="cpu")
    jfn = jax_build_encoder(jax_code(code), "pivot")
    assert fn.k == jfn.k and fn.k >= code.k
    np.testing.assert_array_equal(fn.info_cols, jfn.info_cols)
    u = np.random.default_rng(4).integers(0, 2, (8, fn.k)).astype(np.uint8)
    c = fn(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(c, np.asarray(jfn(u)))
    np.testing.assert_array_equal(c[:, fn.info_cols], u)
    assert _syndrome_zero(code, c)


def test_select_encoder_routes_rank_deficient_to_pivot():
    fn, k, info_cols = select_encoder(sc_code(), device="cpu")
    assert info_cols is not None and k == fn.k
    fn, k, info_cols = select_encoder(toy_code(), device="cpu")
    assert info_cols is None and k == toy_code().k


def test_dual_diagonal_not_ported():
    """(The name is from before the dual-diagonal path was ported.)  It
    now encodes the toy code as the JAX package's path and the port's
    generator path do, and sets .k / .info_cols as they do."""
    code = toy_code()
    fn = build_encoder(code, "dual_diagonal", device="cpu")
    assert fn.k == code.k and fn.info_cols is None
    u = np.random.default_rng(5).integers(0, 2, (8, code.k)).astype(np.uint8)
    c = fn(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(
        c, np.asarray(jax_build_encoder(jax_code(code), "dual_diagonal")(u)))
    np.testing.assert_array_equal(
        c, build_encoder(code, device="cpu")(torch.from_numpy(u)).numpy())
    assert _syndrome_zero(code, c)


DUAL_DIAGONAL_CELLS = ["judged"] + [
    f"{fam}_{rate}" for fam in ("wifi", "wimax")
    for rate in ("1/2", "2/3", "3/4", "5/6")]


@pytest.mark.parametrize("cell", DUAL_DIAGONAL_CELLS)
def test_dual_diagonal_encoder_exact(cell):
    """Bit for bit with the JAX package's dual_diagonal and the port's
    generator path, H c = 0: the judged code and each wifi / wimax rate
    at its smallest lift."""
    if cell == "judged":
        ref = JaxLdpcCode.judged()
    else:
        fam, rate = cell.split("_")
        ref = JaxLdpcCode.from_family(fam, rate, 27 if fam == "wifi" else 24)
    code = twin(ref)
    u = np.random.default_rng(11).integers(0, 2, (16, code.k)).astype(
        np.uint8)
    c = build_encoder(code, "dual_diagonal", device="cpu")(
        torch.from_numpy(u))
    assert c.dtype == torch.uint8 and c.shape == (16, code.n)
    c = c.numpy()
    np.testing.assert_array_equal(
        c, np.asarray(jax_build_encoder(ref, "dual_diagonal")(u)))
    np.testing.assert_array_equal(
        c, build_encoder(code, "generator", device="cpu")(
            torch.from_numpy(u)).numpy())
    assert _syndrome_zero(code, c)


def test_dual_diagonal_refuses_what_jax_refuses():
    from tpu_ldpc.codes.nrlike import nrlike_code

    ref = nrlike_code("1/2", 16)
    with pytest.raises(ValueError) as want:
        jax_build_encoder(ref, "dual_diagonal")
    with pytest.raises(ValueError) as got:
        build_encoder(twin(ref), "dual_diagonal", device="cpu")
    assert str(got.value) == str(want.value)
    assert "not in dual-diagonal form" in str(got.value)
    # closing column of weight 3 whose shifts are not (s, 0, s)
    B = np.asarray(JaxLdpcCode.judged().B).copy()
    rows = [i for i in range(B.shape[0]) if B[i, 8] >= 0]
    B[rows[1], 8] = 5
    bad = JaxLdpcCode.from_base_graph(B, 64, "bad_closing")
    with pytest.raises(ValueError) as want:
        jax_build_encoder(bad, "dual_diagonal")
    with pytest.raises(ValueError) as got:
        build_encoder(twin(bad), "dual_diagonal", device="cpu")
    assert str(got.value) == str(want.value)
    assert "not (s, 0, s)" in str(got.value)


@pytest.mark.parametrize("ebn0_db,rate", [(2.0, 0.5), (-1.5, 2 / 3), (4.25, 5 / 6)])
def test_llrs_from_noise_vs_jax(ebn0_db, rate):
    rng = np.random.default_rng(8)
    c = rng.integers(0, 2, (32, 96)).astype(np.uint8)
    noise = rng.normal(size=c.shape).astype(np.float32)
    assert noise_sigma2(ebn0_db, rate) == jax_noise_sigma2(ebn0_db, rate)
    sigma2 = jnp.float32(jax_noise_sigma2(ebn0_db, rate))
    ref = np.asarray((2.0 / sigma2) * (jax_bpsk(c) + jnp.sqrt(sigma2) * noise))
    got = llrs_from_noise(torch.from_numpy(c), torch.from_numpy(noise),
                          ebn0_db, rate)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_awgn_llrs_follow_the_generator():
    c = torch.zeros((64, 512), dtype=torch.uint8)

    def draw(seed):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return awgn_llrs(c, 2.0, 0.5, g)

    a, b, other = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, other)
    sigma2 = noise_sigma2(2.0, 0.5)
    # all-zero codeword: llr = (2/s2)(1 + sigma n): mean 2/s2, std 2/sigma
    assert abs(a.mean().item() - 2 / sigma2) < 0.05 * 2 / sigma2
    assert abs(a.std().item() - 2 / np.sqrt(sigma2)) < 0.05 * 2 / np.sqrt(sigma2)


@pytest.mark.parametrize("method", ["generator", "dual_diagonal"])
@pytest.mark.parametrize("cell", [("judged",), ("wifi", "2/3", 27)],
                         ids=["judged", "wifi_r23_z27"])
def test_encode_matches_jax(cell, method):
    """encode(code, u, method) equals tpu_ldpc.encode.encode bit for bit."""
    from tpu_ldpc.encode import encode as jax_encode
    from tpu_ldpc_torch.encode import encode

    ref = (JaxLdpcCode.judged() if cell[0] == "judged"
           else JaxLdpcCode.from_family(*cell))
    code = twin(ref)
    u = np.random.default_rng(8).integers(0, 2, (33, code.k)).astype(np.uint8)
    want = np.asarray(jax_encode(ref, u, method))
    got = encode(code, u, method, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor stays on its own device
    assert torch.equal(encode(code, torch.from_numpy(u), method), got)


def test_encode_numpy_input_asks_for_the_card(monkeypatch):
    from tpu_ldpc_torch.encode import encode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = toy_code()
    u = np.zeros((2, code.k), np.uint8)
    with pytest.raises(RuntimeError, match="is_available"):
        encode(code, u)
    with pytest.raises(RuntimeError, match="is_available"):
        encode(code, torch.from_numpy(u), device="cuda")
    assert not encode(code, u, device="cpu").any()
