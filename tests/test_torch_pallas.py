"""Port decoder vs the Pallas TPU kernel, run in interpret mode on the CPU
as tests/test_pallas.py runs it: bit-exact on bits, ok and iters_used.
(The CUDA kernel that replaces the Pallas one is held against the same
plain decoder on the card: chip_smoke.py.)  The port decodes its own
LdpcCode, built from the JAX package's through LdpcCode.from_base_graph.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.pallas_bp import build_pallas_decoder
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.decode.reference import build_decoder

torch.set_num_threads(1)


def toy_code(Z=8):
    return JaxLdpcCode.from_base_graph(
        make_base_graph(4, 8, Z, seed=7), Z, f"toy{Z}")


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def assert_same_as_pallas(code, llr, **kw):
    twin = LdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)
    got = build_decoder(twin, "minsum", **kw)(torch.from_numpy(llr))
    pallas = build_pallas_decoder(code, "minsum", batch_tile=128,
                                  interpret=True, **kw)
    for name, g, w in zip(("bits", "ok", "iters_used"), got, pallas(llr)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("alpha,beta", [(0.75, 0.0), (1.0, 0.15)])
def test_plain_bitexact_vs_pallas_interpret(alpha, beta, early_stop):
    code = toy_code()
    llr = noisy_llrs(code, 40, 2.5, seed=5)
    got = assert_same_as_pallas(code, llr, iters=12, alpha=alpha, beta=beta,
                                early_stop=early_stop)
    assert 0 < got[1].float().mean() < 1  # both converged and failed frames


@pytest.mark.parametrize("batch", [1, 7])
def test_small_batches_vs_pallas_interpret(batch):
    """Batch 1 and a ragged 7 inside one 128-lane Pallas tile."""
    code = toy_code()
    llr = noisy_llrs(code, 40, 2.5, seed=9)
    assert_same_as_pallas(code, llr[:batch], iters=10, alpha=0.75, beta=0.0,
                          early_stop=True)
