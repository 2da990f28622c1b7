"""The CUDA decode kernel on the card: bit-exact against the plain PyTorch
version and the golden float32 model.

Marked `cuda`; each test skips without a CUDA device.  The file imports no
JAX, so on a machine with the card it runs without the JAX conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode
from tpu_ldpc.golden import decode as golden_decode
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.decode.cuda_bp import minsum_flood
from tpu_ldpc_torch.decode.reference import build_decoder

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (torch.cuda.is_available() is False): "
                    "the nvcc-built sm_90a kernel needs an NVIDIA H100 and "
                    "the CUDA toolkit")
    return torch.device("cuda")


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def assert_same(got, want):
    for name, g, w in zip(("bits", "ok", "iters_used"), got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("family,rate,Z,ebn0", [
    ("judged", "1/2", 64, 2.0), ("wifi", "2/3", 27, 2.0),
    ("wimax", "5/6", 96, 3.0)])
def test_kernel_bitexact_vs_plain_and_golden(cuda, family, rate, Z, ebn0,
                                             early_stop):
    code = (LdpcCode.judged() if family == "judged"
            else LdpcCode.from_family(family, rate, Z))
    llr_np = noisy_llrs(code, 257, ebn0, seed=21)
    llr_np[1, ::3] = -0.0
    llr_np[2, ::5] = 1e4
    llr = torch.from_numpy(llr_np).to(cuda)
    before = minsum_flood.launches
    got = minsum_flood(code, llr, 50, 0.75, 0.0, early_stop)
    assert minsum_flood.launches == before + 1
    want = build_decoder(code, "minsum", 50, 0.75, 0.0, "flooding",
                         early_stop)(llr)
    assert_same(got, want)
    assert_same(got, golden_decode(code.H, llr_np, iters=50, alpha=0.75,
                                   dtype=np.float32, early_stop=early_stop))


def test_decode_api_launches_the_kernel_and_checks_inputs(cuda):
    code = LdpcCode.judged()
    llr = torch.from_numpy(noisy_llrs(code, 64, 2.0, seed=3)).to(cuda)
    before = minsum_flood.launches
    current = torch.cuda.current_device()
    got = decode(code, llr)
    assert minsum_flood.launches == before + 1
    assert torch.cuda.current_device() == current
    assert_same(got, decode(code, llr, impl="torch"))
    with pytest.raises(TypeError):
        minsum_flood(code, llr.double())
    with pytest.raises(ValueError, match="contiguous"):
        minsum_flood(code, torch.cat([llr, llr], 1)[:, ::2])
    with pytest.raises(ValueError):
        minsum_flood(code, llr[:, :100].contiguous())
    empty = minsum_flood(code, llr[:0])
    assert empty[0].shape == (0, code.n)
