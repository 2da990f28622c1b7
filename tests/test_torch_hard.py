"""Port hard-decision decoders (tpu_ldpc_torch/decode/hard.py) vs the JAX
package: bit for bit on bits, ok and iters_used against the golden NumPy
model (tpu_ldpc/golden/hard.py) and the jnp decoder
(tpu_ldpc/decode/hard.py), on AWGN and BSC LLRs.

Over the BSC every |llr| is the same, so every check reliability w is
equal, WBF's energies tie across many bits and the first-occurrence rule
of argmax alone picks the flip.  Every input is made with NumPy from a
seed and both packages get the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.hard import build_hard_decoder as jax_build_hard_decoder
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc.golden.hard import decode_hard
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.channel.bsc import bsc_llrs_from_flips
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.hard import build_hard_decoder, parity_tables
from tpu_ldpc_torch.sim.mc import DecodeCfg, run_ber

torch.set_num_threads(1)


def jax_toy():
    return JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7), 8,
                                       "toy8")


CODES = {"toy": jax_toy, "judged": JaxLdpcCode.judged}


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def codewords(ref, batch, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, ref.k)).astype(np.uint8)
    return golden_encode(ref.H, u), rng


def awgn_llrs(ref, batch, ebn0_db, seed):
    c, rng = codewords(ref, batch, seed)
    sigma2 = 1.0 / (2 * ref.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def bsc_llrs(ref, batch, p, seed):
    c, rng = codewords(ref, batch, seed)
    flips = rng.random(c.shape) < p
    llr = bsc_llrs_from_flips(torch.from_numpy(c), torch.from_numpy(flips), p)
    return llr.numpy(), c


def port(ref, llr, algo, iters):
    fn = build_hard_decoder(twin(ref), algo, iters, device="cpu")
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def assert_matches_golden_and_jax(ref, llr, algo, iters):
    got = port(ref, llr, algo, iters)
    assert got[0].dtype == np.uint8 and got[1].dtype == np.bool_
    assert got[2].dtype == np.int32
    assert_same(got, decode_hard(ref.H, llr, algo=algo, iters=iters))
    assert_same(got, jax_build_hard_decoder(ref, algo=algo, iters=iters)(
        jnp.asarray(llr)))
    return got


@pytest.mark.parametrize("algo,name,iters", [
    ("bitflip", "toy", 20), ("bitflip", "judged", 10),
    ("wbf", "toy", 20), ("wbf", "judged", 8)])
def test_awgn_bit_exact_vs_golden_and_jax(algo, name, iters):
    """The sizes of tests/test_hard.py: mid-SNR LLRs, so flips happen."""
    ref = CODES[name]()
    llr = awgn_llrs(ref, 24, 4.0, seed=3)
    assert_matches_golden_and_jax(ref, llr, algo, iters)


@pytest.mark.parametrize("algo,name,iters", [
    ("bitflip", "judged", 10), ("wbf", "judged", 8), ("wbf", "toy", 20)])
@pytest.mark.parametrize("p", [0.002, 0.02])
def test_bsc_bit_exact_vs_golden_and_jax(algo, name, iters, p):
    """Equal |llr| everywhere: WBF's flip is decided by ties alone."""
    ref = CODES[name]()
    llr, _ = bsc_llrs(ref, 32, p, seed=11)
    assert np.unique(np.abs(llr)).size == 1
    got = assert_matches_golden_and_jax(ref, llr, algo, iters)
    if p == 0.002 and name == "judged":
        # frames converge at different iterations: the freeze is exercised
        assert 0 < got[1].mean() and len(np.unique(got[2])) > 1


def test_tables_follow_the_circulants():
    ref = jax_toy()
    chk_var, var_chk, col_deg = parity_tables(twin(ref))
    H = np.zeros((ref.m, ref.n), np.int64)
    for r, vs in enumerate(chk_var):
        H[r, vs[vs < ref.n]] += 1
    np.testing.assert_array_equal(H, np.asarray(ref.H.todense()
                                                if hasattr(ref.H, "todense")
                                                else ref.H))
    np.testing.assert_array_equal(col_deg, H.sum(axis=0))
    for v, cs in enumerate(var_chk):
        cs = cs[cs < ref.m]
        assert list(cs) == sorted(np.flatnonzero(H[:, v]))


def test_bitflip_corrects_single_error():
    ref = JaxLdpcCode.judged()
    c, rng = codewords(ref, 8, seed=4)
    llr = (1.0 - 2.0 * c).astype(np.float32)
    llr[np.arange(8), rng.integers(0, ref.n, 8)] *= -1.0
    bits, ok, iu = port(ref, llr, "bitflip", 10)
    assert ok.all() and (iu == 1).all()
    np.testing.assert_array_equal(bits, c)


def test_bsc_bitflip_decodes():
    ref = JaxLdpcCode.judged()
    llr, c = bsc_llrs(ref, 64, 0.002, seed=1)
    bits, _, _ = port(ref, llr, "bitflip", 30)
    assert (bits == c).all(axis=1).mean() >= 0.9  # ~2 flips a frame


def test_wbf_flips_one_bit_per_iteration():
    ref = jax_toy()
    c, rng = codewords(ref, 4, seed=5)
    llr = (1.0 - 2.0 * c).astype(np.float32)
    llr[np.arange(4), rng.integers(0, ref.n, 4)] *= -1.0
    _, ok, iu = port(ref, llr, "wbf", 5)
    assert ok.all() and (iu == 1).all()  # one error, one flip


def test_hard_validation():
    with pytest.raises(ValueError, match="hard algo"):
        build_hard_decoder(twin(jax_toy()), "minsum", device="cpu")


@pytest.mark.parametrize("algo", ["bitflip", "wbf"])
def test_decode_routes_hard_algos(algo):
    ref = jax_toy()
    llr = awgn_llrs(ref, 16, 4.0, seed=8)
    got = decode(twin(ref), llr, algo=algo, iters=20, device="cpu")
    assert_same([x.numpy() for x in got],
                decode_hard(ref.H, llr, algo=algo, iters=20))
    with pytest.raises(ValueError, match="quant"):
        decode(twin(ref), llr, algo=algo, quant_bits=6, device="cpu")


@pytest.mark.parametrize("algo", ["bitflip", "wbf"])
def test_run_ber_with_hard_decoders(algo):
    """Same draws as min-sum BP (the PRNG rule is per batch): the hard
    decoder makes at least as many frame errors on the toy code."""
    code = twin(jax_toy())
    kw = dict(batch=64, target_frame_errors=10**9, max_frames=256, seed=1,
              device="cpu")
    soft = run_ber(code, [4.0], DecodeCfg(iters=20), **kw)[0]
    hard = run_ber(code, [4.0], DecodeCfg(algo=algo, iters=20), **kw)[0]
    assert hard.frames == 256 and hard.bits == 256 * code.k
    assert 0 < hard.mean_iters <= 20
    assert hard.frame_errors >= soft.frame_errors


def test_cli_bitflip(capsys):
    from tpu_ldpc_torch.cli.sim import main

    results = main(["--family", "judged", "--algo", "bitflip", "--ebn0",
                    "4.0", "--iters", "10", "--device", "cpu", "--batch",
                    "16", "--max-frames", "32"])
    assert results[0].frames == 32
    assert "algo=bitflip" in capsys.readouterr().out
