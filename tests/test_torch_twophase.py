"""The port's single-pass early-terminated decoder against the JAX
package's two-phase decoder.

The port has one early-termination path: ``decode(impl='auto')``, whose
codewords each stop at their own iteration.  The JAX package keeps
two-phase decoding (a short ET pass over the batch, then its stragglers
compacted into `budget` lanes and decoded again with the full budget),
whose outputs are bit-identical to single-pass ET.  So the port's
decode() must give the JAX two-phase decoder's bits, ok and iters_used,
in both of its branches: stragglers that fit the budget, and a batch
that overflows it and is decoded again in full.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.twophase import (
    build_twophase_decoder as jax_build_twophase_decoder)
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode import decode

torch.set_num_threads(1)

ITERS, PHASE1_ITERS, BUDGET, BATCH = 20, 4, 32, 64
MODES = {"minsum": {}, "sumproduct": {"algo": "sumproduct"},
         "minsum-q5": {"quant_bits": 5, "quant_step": 0.5}}
# (Eb/N0, seed): stragglers within the budget, and more than it
BATCHES = {"fits": (2.0, 41), "overflows": (1.0, 42)}


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


@pytest.fixture(scope="module")
def jax_twophase():
    """One JAX two-phase decoder (Pallas, interpret mode) per (mode,
    schedule), built at first use and shared by both batches."""
    ref, _ = toy_codes()
    built = {}

    def get(mode, schedule):
        if (mode, schedule) not in built:
            built[mode, schedule] = jax_build_twophase_decoder(
                ref, ITERS, PHASE1_ITERS, BUDGET, interpret=True,
                report_fallback=True, schedule=schedule, **MODES[mode])
        return built[mode, schedule]

    return get


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("mode", list(MODES))
def test_single_pass_et_equals_jax_twophase(mode, schedule, batch,
                                            jax_twophase):
    _, code = toy_codes()
    llr = noisy_llrs(code, BATCH, *BATCHES[batch])
    *want, n_unconv = jax_twophase(mode, schedule)(llr)
    if batch == "fits":
        assert 0 < int(n_unconv) <= BUDGET  # the compacted branch ran
    else:
        assert int(n_unconv) > BUDGET  # the full-batch branch ran
    got = decode(code, llr, iters=ITERS, schedule=schedule, impl="auto",
                 device="cpu", **MODES[mode])
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    ok = got[1].numpy()
    assert 0 < ok.sum() < len(ok)  # converged and failed frames alike
