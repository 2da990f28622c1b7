"""Port windowed SC-LDPC decoder (tpu_ldpc_torch/decode/windowed.py) vs
the JAX package's (tpu_ldpc/decode/windowed.py) on make_sc_base_graph
chains, and its internal pins against the port's own plain decoder.

Min-sum and sumproduct-fast are compared bit for bit (bits, ok,
iters_used), sliding and full windows, both sweeps.  Exact sum-product
rounds tanh and log differently in each framework, so it is held to the
package's sum-product contract: bits and ok agree on at least 97% of
frames.  Against the port's own reference decoder (same framework, same
operations) every algorithm is bit for bit.  Every input is made with
NumPy from a seed and both packages get the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes.base_graphs import make_sc_base_graph as jax_sc_graph
from tpu_ldpc.decode.windowed import banded_tables as jax_banded_tables
from tpu_ldpc.decode.windowed import (
    build_windowed_decoder as jax_build_windowed_decoder)
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.api import build_decode_fn
from tpu_ldpc_torch.decode.reference import build_decoder
from tpu_ldpc_torch.decode.windowed import (
    banded_tables, build_windowed_decoder)
from tpu_ldpc_torch.sim.mc import DecodeCfg, run_ber

torch.set_num_threads(1)
SP_MIN_AGREEMENT = 0.97  # the package's sum-product frame contract


def sc_code(L=8, Z=8, seed=3):
    return LdpcCode.from_base_graph(make_sc_base_graph(L, Z, seed=seed), Z,
                                    f"sc_l{L}_z{Z}")


def jax_twin(code):
    return JaxLdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)


def noisy_zero_llrs(code, ebn0_db, batch, seed=0):
    """LLRs of the all-zero codeword (the chain is rank-deficient)."""
    rng = np.random.default_rng(seed)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = 1.0 + np.sqrt(sigma2) * rng.normal(size=(batch, code.n))
    return (2.0 / sigma2 * y).astype(np.float32)


def port(code, llr, window, ipw, algo="minsum", sweep="flooding"):
    fn = build_windowed_decoder(code, window, ipw, algo, sweep=sweep,
                                device="cpu")
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


def jax_run(code, llr, window, ipw, algo="minsum", sweep="flooding"):
    fn = jax_build_windowed_decoder(jax_twin(code), window, ipw, algo,
                                    sweep=sweep)
    return [np.asarray(x) for x in fn(jnp.asarray(llr))]


def plain(code, llr, algo, iters, schedule="flooding"):
    fn = build_decoder(code, algo, iters, early_stop=False,
                       schedule=schedule)
    return [x.numpy() for x in fn(torch.from_numpy(llr))]


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("L,Z", [(8, 8), (16, 16)])
def test_banded_tables_equal_jax(L, Z):
    code = sc_code(L, Z)
    assert np.array_equal(np.asarray(code.B),
                          np.asarray(jax_sc_graph(L, Z, seed=3)))
    S, M = banded_tables(code)
    S_j, M_j = jax_banded_tables(jax_twin(code))
    np.testing.assert_array_equal(S, S_j)
    np.testing.assert_array_equal(M, M_j)
    assert M.sum() == (np.asarray(code.B) >= 0).sum()
    assert M[3].all() and M[code.mb - 3].all()  # interior rows: degree 6
    judged = LdpcCode.judged()
    for fn, c in ((banded_tables, judged),
                  (jax_banded_tables, jax_twin(judged))):
        with pytest.raises(ValueError, match="banded"):
            fn(c)


# (L, Z, window (0: all mb rows), iterations per window, algo, sweep,
# Eb/N0): every W in {4, 6, mb}, both sweeps, 1-3 iterations per window
BIT_EXACT_CASES = [
    (8, 8, 4, 2, "minsum", "flooding", 1.5),
    (8, 8, 4, 3, "sumproduct-fast", "layered", 1.5),
    (16, 16, 6, 1, "sumproduct-fast", "flooding", 2.0),
    (16, 16, 6, 3, "minsum", "layered", 2.0),
    (4, 16, 0, 2, "sumproduct-fast", "flooding", 4.0),
    (4, 8, 0, 1, "minsum", "layered", 3.5),
]


@pytest.mark.parametrize("L,Z,W,ipw,algo,sweep,ebn0", BIT_EXACT_CASES)
def test_bit_exact_vs_jax(L, Z, W, ipw, algo, sweep, ebn0):
    code = sc_code(L, Z)
    W = W or code.mb
    llr = noisy_zero_llrs(code, ebn0, 48, seed=L + Z + W)
    got = port(code, llr, W, ipw, algo, sweep)
    assert 0 < got[1].mean() < 1  # decoded and failed frames both
    n_windows = code.mb - W + 1
    assert (got[2] == n_windows * ipw).all() and got[2].dtype == np.int32
    assert_same(got, jax_run(code, llr, W, ipw, algo, sweep))


@pytest.mark.parametrize("L,Z,W,ipw,algo,sweep,_", BIT_EXACT_CASES[:2])
def test_ties_bit_exact_vs_jax(L, Z, W, ipw, algo, sweep, _):
    """BSC LLRs (one magnitude): the two-min and three-smallest scans meet
    equal magnitudes everywhere, and which of them ranks first must
    change no message."""
    code = sc_code(L, Z)
    rng = np.random.default_rng(5)
    flips = rng.random((48, code.n)) < 0.06  # the all-zero codeword
    llr = np.where(flips, -2.75, 2.75).astype(np.float32)
    got = port(code, llr, W, ipw, algo, sweep)
    assert 0 < got[1].mean() < 1
    assert_same(got, jax_run(code, llr, W, ipw, algo, sweep))


@pytest.mark.parametrize("sweep,W,ipw", [("flooding", 4, 3),
                                         ("layered", 4, 2)])
def test_sumproduct_agrees_with_jax(sweep, W, ipw):
    """Exact sum-product: bits and ok agree on >= 97% of frames (the
    package's sum-product contract; each framework rounds tanh / log
    its own way)."""
    code = sc_code(16, 8)
    llr = noisy_zero_llrs(code, 1.8, 64, seed=7)
    got = port(code, llr, W, ipw, "sumproduct", sweep)
    want = jax_run(code, llr, W, ipw, "sumproduct", sweep)
    same = (got[0] == want[0]).all(axis=1) & (got[1] == want[1])
    assert same.mean() >= SP_MIN_AGREEMENT, same.mean()
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("algo", ["minsum", "sumproduct",
                                  "sumproduct-fast"])
@pytest.mark.parametrize("sweep", ["flooding", "layered"])
def test_full_window_equals_plain_decoder(algo, sweep):
    """W = mb, one slide, I iterations == the plain decoder's I
    iterations without early termination (flooding or layered)."""
    code = sc_code(8, 8)
    iters = 12 if sweep == "flooding" else 10
    llr = noisy_zero_llrs(code, 1.0, 16)
    got = port(code, llr, code.mb, iters, algo, sweep)
    assert_same(got[:2], plain(code, llr, algo, iters, sweep)[:2])


def test_full_window_posterior_bit_exact_minsum():
    code = sc_code(6, 16, seed=5)
    llr = noisy_zero_llrs(code, 2.0, 32, seed=9)
    got = port(code, llr, code.mb, 30)
    np.testing.assert_array_equal(got[0], plain(code, llr, "minsum", 30)[0])


def test_sliding_window_decodes_high_snr():
    code = sc_code(16, 16, seed=1)
    bits, ok, iu = port(code, noisy_zero_llrs(code, 6.0, 16), 6, 2)
    assert ok.all() and (bits == 0).all()
    assert (iu == 2 * (code.mb - 6 + 1)).all()


def test_window_quality_monotone_in_width():
    """Wider windows approach full-chain BP from above (fixed seed,
    deterministic decoders)."""
    code = sc_code(32, 8, seed=1)
    llr = noisy_zero_llrs(code, 2.5, 64, seed=4)
    errors = {}
    for name, bits in (("narrow", port(code, llr, 6, 3)[0]),
                       ("wide", port(code, llr, 10, 3)[0]),
                       ("full", plain(code, llr, "minsum", 50)[0])):
        errors[name] = int(bits.any(axis=1).sum())
    assert errors["full"] <= errors["wide"] < errors["narrow"]


def test_sliding_window_decodes_random_codewords():
    """Encoded frames (the pivot encoder: the terminated chain is
    rank-deficient) come back as sent."""
    from tpu_ldpc_torch.encode.encoder import select_encoder

    code = sc_code(16, 16, seed=1)
    enc, k_true, _ = select_encoder(code, device="cpu")
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, (16, k_true)).astype(np.uint8)
    c = enc(torch.from_numpy(u)).numpy()
    sigma2 = 1.0 / (2 * code.rate * 10 ** 0.6)
    llr = (2.0 / sigma2 * ((1.0 - 2.0 * c) + np.sqrt(sigma2)
                           * rng.normal(size=c.shape))).astype(np.float32)
    bits, ok, _ = port(code, llr, 6, 2)
    assert ok.mean() > 0.9
    assert (bits[ok] == c[ok]).all()


def test_layered_sweep_beats_flooding_sweep():
    """The layered sweep rides the slide direction: at equal (W,
    iterations per slide) it decodes at least as many frames."""
    code = sc_code(16, 8)
    llr = noisy_zero_llrs(code, 1.6, 96)
    wrong_f = int(port(code, llr, 6, 2)[0].any(axis=1).sum())
    wrong_l = int(port(code, llr, 6, 2, sweep="layered")[0].any(axis=1).sum())
    assert wrong_l <= wrong_f


def test_window_validation():
    code = sc_code()
    for kw, match in ((dict(window=0), "window"),
                      (dict(window=code.mb + 1), "window"),
                      (dict(window=4, algo="nope"), "algo"),
                      (dict(window=4, sweep="nope"), "sweep")):
        with pytest.raises(ValueError, match=match):
            build_windowed_decoder(code, device="cpu", **kw)
    with pytest.raises(ValueError, match="banded"):
        build_windowed_decoder(LdpcCode.judged(), 4, device="cpu")


def test_window_sweep_rejected_outside_windowed_schedule():
    code = sc_code()
    for schedule in ("flooding", "layered"):
        with pytest.raises(ValueError, match="window_sweep"):
            build_decode_fn(code, DecodeCfg(schedule=schedule,
                                            window_sweep="layered"), "cpu")
    with pytest.raises(ValueError, match="quant"):
        build_decode_fn(code, DecodeCfg(schedule="windowed", quant_bits=6),
                        "cpu")


def test_build_decode_fn_and_decode_route_windowed():
    code = sc_code(16, 8)
    llr = noisy_zero_llrs(code, 1.6, 32, seed=3)
    want = port(code, llr, 6, 2, sweep="layered")
    fn = build_decode_fn(code, DecodeCfg(schedule="windowed", window=6,
                                         window_sweep="layered", iters=2),
                         "cpu")
    assert_same([x.numpy() for x in fn(torch.from_numpy(llr))], want)
    got = decode(code, llr, iters=2, schedule="windowed", window=6,
                 window_sweep="layered", device="cpu")
    assert_same([x.numpy() for x in got], want)


@pytest.mark.parametrize("sweep", ["flooding", "layered"])
def test_run_ber_windowed(sweep):
    """DecodeCfg(schedule='windowed') through run_ber (pivot encoder)."""
    code = sc_code(8, 8)
    cfg = DecodeCfg(iters=2, schedule="windowed", window=5,
                    window_sweep=sweep)
    res = run_ber(code, [7.0], cfg, batch=32, target_frame_errors=5,
                  max_frames=64, seed=0, device="cpu")[0]
    assert res.frames == 64 and res.fer < 0.5
    assert res.mean_iters == 2 * (code.mb - 5 + 1)


def test_cli_windowed_and_config(tmp_path, capsys):
    import json

    from tpu_ldpc_torch.cli.config import SimConfig
    from tpu_ldpc_torch.cli.sim import main

    results = main(["--family", "sc", "--sc-length", "8", "--z", "8",
                    "--schedule", "windowed", "--window", "5",
                    "--window-sweep", "layered", "--iters", "2",
                    "--ebn0", "5.0", "--device", "cpu", "--batch", "32",
                    "--max-frames", "64"])
    assert results[0].frames == 64
    out = capsys.readouterr().out
    assert "schedule=windowed window=5 sweep=layered" in out
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"decode": {"schedule": "windowed",
                                               "window": 6}}))
    from_json = SimConfig.from_sources(str(cfg_file))
    from_set = SimConfig.from_sources(None, ["decode.schedule=windowed",
                                             "decode.window=6"])
    assert from_json.decode.window == from_set.decode.window == 6
    assert from_json.config_hash() == from_set.config_hash()
