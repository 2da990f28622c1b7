"""The trapping-set census in the port (codes/trapping.py) against the JAX
package's on tests/test_trapping.py's n=64 toy: classify on known
supports, harvest_failures with device='cpu' (the plain PyTorch min-sum)
failure for failure against the JAX harvest (its native CPU min-sum), on
the same paired-seed frames, and census."""

import dataclasses

import numpy as np
import pytest

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph as jax_make_base_graph
from tpu_ldpc.codes import trapping as jax_trapping
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch.codes import LdpcCode, trapping
from tpu_ldpc_torch.codes.gf2 import encode, parity_map


@pytest.fixture(scope="module")
def codes():
    ref = JaxLdpcCode.from_base_graph(jax_make_base_graph(4, 8, 4, seed=7),
                                      8, "trap_toy")  # n=64, k=32
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def fields(failures):
    return [dataclasses.astuple(f) for f in failures]


def test_classify_known_supports(codes):
    ref, code = codes
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (3, code.k)).astype(np.uint8)
    c = encode(code.H, u)
    assert np.array_equal(c, golden_encode(ref.H, u))
    assert np.array_equal(encode(code.H, u, parity_map(code.H)), c)
    H = np.asarray(code.H.todense())
    bits = c.copy()
    bits[0, [3, 17]] ^= 1                 # 2-bit error
    bits[1] ^= c[1] ^ c[0]                # decoded ANOTHER codeword
    fails = trapping.classify(code.H, c, bits, code.k)
    assert fields(fails) == fields(jax_trapping.classify(ref.H, c, bits,
                                                         ref.k))
    assert len(fails) == 2
    f0, f1 = fails
    assert (f0.lane, f0.a, f0.support) == (0, 2, (3, 17))
    assert f0.b == int((H[:, [3, 17]].sum(axis=1) % 2).sum())
    assert f1.lane == 1 and f1.b == 0
    assert f1.a == int((c[1] ^ c[0]).sum())
    assert f1.info_wrong == int((c[1] ^ c[0])[: code.k].sum())
    assert trapping.classify(code.H, c, c, code.k) == []


@pytest.mark.parametrize("ebn0,kw", [
    (2.0, dict(iters=15, target=20, max_frames=4096, chunk=256)),
    (2.0, dict(iters=15, target=10, max_frames=4096, chunk=256, n_punct=8)),
    (1.5, dict(iters=20, alpha=0.8, target=6, max_frames=4096, chunk=128,
               target_info_wrong=True, seed_tag="tag")),
])
def test_harvest_equals_jax(codes, ebn0, kw):
    ref, code = codes
    seen = []
    got, frames = trapping.harvest_failures(
        code, ebn0, device="cpu", progress=lambda f, n: seen.append((f, n)),
        **kw)
    want, want_frames = jax_trapping.harvest_failures(ref, ebn0, **kw)
    assert frames == want_frames
    assert fields(got) == fields(want)
    assert seen[-1] == (frames, len(got))
    counted = [f for f in got
               if f.info_wrong > 0 or not kw.get("target_info_wrong")]
    assert len(counted) >= kw["target"] or frames >= kw["max_frames"]
    rep, want_rep = trapping.census(got), jax_trapping.census(want)
    assert rep == want_rep


def test_chunk_frames_are_the_reference_draws(codes):
    """chunk_frames draws what the JAX harvest draws for a chunk: a
    decoder that returns the transmitted codeword finds no failure, one
    that returns the hard decision of the LLRs finds the same failures
    in both packages."""
    ref, code = codes
    M = parity_map(code.H)
    c, llr = trapping.chunk_frames(code, M, "t", 1.0, 3, 64, n_punct=8)
    assert c.shape == llr.shape == (64, code.n) and llr.dtype == np.float32
    assert (llr[:, :8] == 0).all() and not np.signbit(llr[:, :8]).any()
    assert (code.H @ c.T % 2 == 0).all()

    def hard(llr):
        return (llr < 0).astype(np.uint8), None, None

    kw = dict(target=10**9, max_frames=256, chunk=64, n_punct=8,
              seed_tag="t", decode=hard)
    got, _ = trapping.harvest_failures(code, 1.0, **kw)
    want, _ = jax_trapping.harvest_failures(ref, 1.0, **kw)
    assert fields(got) == fields(want) and len(got) > 0
    assert [f for f in got if f.chunk == 3] == trapping.classify(
        code.H, c, hard(llr)[0], code.k, chunk=3)


def test_harvest_asks_for_the_card(codes, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        trapping.harvest_failures(codes[1], 2.0, target=1, chunk=16)
