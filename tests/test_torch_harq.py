"""Port IR-HARQ (tpu_ldpc_torch/sim/harq.py) vs the JAX package's.

Both draw the payload, its CRC and the noise with NumPy's
default_rng(seed) in the same order, so they see the same frames draw
for draw: the port with its plain decoder (impl='torch') on the CPU must
equal the JAX package's jnp run (impl='jnp') field for field, every
stage dict included, on the JAX tests' ladders (tests/test_harq.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_ldpc.sim.harq import run_irharq as jax_run_irharq
from tpu_ldpc_torch.sim.harq import HarqResult, run_irharq

torch.set_num_threads(1)

Z = 16


@pytest.mark.parametrize("kw", [
    dict(stage_m=(7, 13, 24), ebn0_db=1.0, batch=96, iters=30, seed=1),
    dict(stage_m=(7, 13, 24), ebn0_db=1.0, batch=96, iters=30, seed=1,
         crc=None),
    dict(stage_m=(7, 17, 42), ebn0_db=0.5, batch=64, iters=40, seed=4, bg=2),
], ids=["bg1_crc24", "bg1_genie", "bg2_crc24"])
def test_irharq_equals_jax(kw):
    got = run_irharq(Z=Z, impl="torch", device="cpu", **kw)
    want = jax_run_irharq(Z=Z, impl="jnp", **kw)
    assert isinstance(got, HarqResult)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.residual_fer == want.residual_fer
    assert got.false_ack_rate == want.false_ack_rate
    fers = [s["fer_after"] for s in got.stages]
    assert fers[0] > fers[-1]  # the increments delivered frames


def test_irharq_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_irharq(Z=Z, stage_m=(7,), batch=4)
    with pytest.raises(ValueError, match="stage_m must lie in"):
        run_irharq(Z=Z, stage_m=(3, 7), batch=4, device="cpu")


def test_irharq_punctured_pair_is_an_exact_erasure():
    """The mother codeword prefix is a codeword of every stage's code,
    and the never-sent pair reaches the decoder as +0.0."""
    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.codes.nrlike import KB, make_nrlike_base_graph
    from tpu_ldpc_torch.encode.encoder import select_encoder

    mother = LdpcCode("m", make_nrlike_base_graph(Z, m=24), Z)
    enc, k, info_cols = select_encoder(mother, device="cpu")
    assert info_cols is None and k == mother.k
    u = np.random.default_rng(3).integers(0, 2, (4, k)).astype(np.uint8)
    c = enc(torch.from_numpy(u)).numpy()
    for m in (4, 7, 13, 24):
        code_m = LdpcCode("t", make_nrlike_base_graph(Z, m=m), Z)
        syn = code_m.H @ c[:, :(KB + m) * Z].T.astype(np.int64)
        assert not (syn % 2).any(), m
    # every lane decodes a noiseless first stage with no iteration left
    res = run_irharq(Z=Z, stage_m=(7, 24), ebn0_db=40.0, batch=8,
                     iters=20, impl="torch", device="cpu")
    assert res.delivered == 8 and res.avg_bits_sent == res.stages[0][
        "n_tx_cum"]
