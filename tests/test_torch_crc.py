"""Port outer CRC (tpu_ldpc_torch/codes/crc.py) vs the JAX package's.

The NumPy part is a copy: the LFSR remainder, the generator matrix and
the check matrix must equal the JAX package's for every standard
polynomial and a custom one.  The torch attacher and checker are one
float64 product each and must equal the golden attach / check exactly,
also when float32 matmuls are allowed to run in TF32.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import crc as jcrc
from tpu_ldpc_torch.codes import crc

torch.set_num_threads(1)

CUSTOM = (("crc5_custom", 5, 0x15),)
SPEC_NAMES = sorted(crc.SPECS) + ["custom"]


def specs(name):
    """(port spec, JAX spec) of a SPECS name or the custom polynomial."""
    if name == "custom":
        return crc.CrcSpec(*CUSTOM[0]), jcrc.CrcSpec(*CUSTOM[0])
    return crc.get_spec(name), jcrc.get_spec(name)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_numpy_copy_equals_jax(name):
    spec, jspec = specs(name)
    assert (spec.name, spec.width, spec.poly) == (jspec.name, jspec.width,
                                                  jspec.poly)
    np.testing.assert_array_equal(spec.poly_bits(), jspec.poly_bits())
    rng = np.random.default_rng(5)
    for k in (1, 37, 200):
        bits = rng.integers(0, 2, (6, k)).astype(np.uint8)
        rem = crc.crc_remainder(bits, spec)
        np.testing.assert_array_equal(rem, jcrc.crc_remainder(bits, jspec))
        m = crc.crc_matrix(k, spec)
        np.testing.assert_array_equal(m, jcrc.crc_matrix(k, jspec))
        np.testing.assert_array_equal((bits @ m.T.astype(np.int64)) % 2, rem)
        kt = k + spec.width
        np.testing.assert_array_equal(crc.check_matrix(kt, spec),
                                      jcrc.check_matrix(kt, jspec))
        frames = crc.attach(bits, spec)
        np.testing.assert_array_equal(frames, jcrc.attach(bits, jspec))
        assert crc.check(frames, spec).all()


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_torch_attach_and_check_equal_golden(name):
    spec, jspec = specs(name)
    rng = np.random.default_rng(6)
    kp = 300
    payload = rng.integers(0, 2, (64, kp)).astype(np.uint8)
    attach = crc.make_crc_attacher(kp, spec, device="cpu")
    frames = attach(torch.from_numpy(payload))
    assert frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.numpy(), jcrc.attach(payload, jspec))
    # corrupt half the frames: one, two or a burst of bits
    bad = frames.numpy().copy()
    for r in range(0, 64, 2):
        pos = rng.choice(kp + spec.width, size=1 + r % 3, replace=False)
        bad[r, pos] ^= 1
    ok = crc.make_crc_checker(kp + spec.width, spec, device="cpu")(
        torch.from_numpy(bad))
    assert ok.dtype == torch.bool
    np.testing.assert_array_equal(ok.numpy(), jcrc.check(bad, jspec))
    assert ok.numpy()[1::2].all()


def test_products_exact_with_tf32_allowed():
    """The float64 products ignore float32 matmul precision settings."""
    spec = crc.get_spec("crc32")
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 2, (32, 4000)).astype(np.uint8)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        frames = crc.make_crc_attacher(4000, spec, device="cpu")(
            torch.from_numpy(payload))
        ok = crc.make_crc_checker(4032, spec, device="cpu")(frames)
    finally:
        torch.set_float32_matmul_precision(before)
    np.testing.assert_array_equal(frames.numpy(),
                                  jcrc.attach(payload, "crc32"))
    assert ok.all()


def test_errors_match_jax():
    for mod in (crc, jcrc):
        with pytest.raises(ValueError, match="unknown CRC"):
            mod.get_spec("crc7")
        with pytest.raises(ValueError, match="<= CRC width"):
            mod.check_matrix(16, "crc16")
