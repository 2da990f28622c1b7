"""Port NR-like rate-compatible family (tpu_ldpc_torch/codes/nrlike.py)
vs the JAX package's, and its config / CLI surface.

The base graphs are a NumPy copy over the port's own select_shifts:
every rate point of both families must equal the JAX package's table at
Z=16, as must the transmitted rate under the family's puncturing.
"""

import numpy as np
import pytest
import torch

from tpu_ldpc.codes import nrlike as jnr
from tpu_ldpc_torch.cli.config import ChannelCfg, CodeSpec
from tpu_ldpc_torch.codes import nrlike

torch.set_num_threads(1)

Z = 16


def test_constants_equal_jax():
    for name in ("KB", "M_MOTHER", "M_BY_RATE", "KB2", "M_MOTHER2",
                 "M_BY_RATE2"):
        assert getattr(nrlike, name) == getattr(jnr, name), name


@pytest.mark.parametrize("bg", [1, 2])
def test_base_graphs_equal_jax(bg):
    kb, table = ((nrlike.KB, nrlike.M_BY_RATE) if bg == 1
                 else (nrlike.KB2, nrlike.M_BY_RATE2))
    mask, fixed = nrlike._mother_mask(kb, max(table.values()), 11)
    jmask, jfixed = jnr._mother_mask(kb, max(table.values()), 11)
    np.testing.assert_array_equal(mask, jmask)
    assert fixed == jfixed
    for rate, m in table.items():
        B = nrlike.make_nrlike_base_graph(Z, m=m, kb=kb)
        np.testing.assert_array_equal(
            B, jnr.make_nrlike_base_graph(Z, m=m, kb=kb))
        code = nrlike.nrlike_code(rate, Z, bg=bg)
        jcode = jnr.nrlike_code(rate, Z, bg=bg)
        name = f"nr{bg}_r{rate.replace('/', '')}_z{Z}"
        assert code.name == jcode.name == name
        np.testing.assert_array_equal(code.B, np.asarray(jcode.B))
        assert nrlike.tx_rate(code) == jnr.tx_rate(jcode)
        a, ja = nrlike.nrlike_adapt(code), jnr.nrlike_adapt(jcode)
        assert (a.puncture, a.shorten) == (ja.puncture, ja.shorten)
    with pytest.raises(ValueError, match="m must be in"):
        nrlike.make_nrlike_base_graph(Z, m=3, kb=kb)
    with pytest.raises(ValueError, match="rate must be one of"):
        nrlike.nrlike_code("9/10", Z, bg=bg)


@pytest.mark.parametrize("family,rate,name", [
    ("nr", "1/2", "nr1_r12_z16"), ("nr", "5/6", "nr1_r56_z16"),
    ("nr2", "1/5", "nr2_r15_z16"), ("nr2", "2/3", "nr2_r23_z16")])
def test_codespec_builds_nr(family, rate, name):
    code = CodeSpec(family=family, rate=rate, Z=Z).build()
    assert code.name == name
    adapt = ChannelCfg().build_adapt(code)
    assert adapt.puncture == tuple(range(2 * Z))  # the two high-degree blocks
    assert adapt.rate(code.n, code.k) == nrlike.tx_rate(code)
    # an explicit adaptation wins over the family default
    explicit = ChannelCfg(puncture_blocks=(code.nb - 1,)).build_adapt(code)
    assert explicit.puncture == tuple(range((code.nb - 1) * Z, code.n))


def test_build_adapt_punctures_registry_names_only():
    from tpu_ldpc_torch import LdpcCode

    B = nrlike.make_nrlike_base_graph(Z, m=nrlike.M_MOTHER)
    for name in ("nr1_m24_z16", "nr1_r12_z16_custom", "xnr1_r12_z16",
                 "custom"):
        assert ChannelCfg().build_adapt(LdpcCode(name, B, Z)) is None, name
    assert ChannelCfg().build_adapt(LdpcCode("nr1_r12_z16", B, Z)) is not None
    assert ChannelCfg().build_adapt(CodeSpec().build()) is None  # judged


@pytest.mark.parametrize("flags,line", [
    (["--family", "nr", "--rate", "3/4", "--z", "16", "--crc", "crc16"],
     "rate adaptation: punctured=32 shortened=0 -> (n_tx=480, k_eff=352, "
     "R_eff=0.733)"),
    (["--family", "judged", "--shorten-blocks", "0"],
     "rate adaptation: punctured=0 shortened=64 -> (n_tx=960, k_eff=448, "
     "R_eff=0.467)"),
], ids=["nr_crc16", "judged_shorten"])
def test_sim_cli_rate_adaptation(tmp_path, capsys, flags, line):
    from tpu_ldpc_torch.cli.config import SimConfig
    from tpu_ldpc_torch.cli.sim import main

    csv = str(tmp_path / "out.csv")
    results = main([*flags, "--ebn0", "2.0", "--iters", "10", "--device",
                    "cpu", "--batch", "16", "--target-fe", "5",
                    "--max-frames", "32", "--csv", csv])
    out = capsys.readouterr().out
    assert line in out
    assert results[0].frames >= 16
    row = dict(zip(*(ln.split(",") for ln in
                     open(csv).read().strip().splitlines()[1:3])))
    assert int(row["frames"]) == results[0].frames
    k = {"nr_crc16": 352 - 16, "judged_shorten": 448}[
        "nr_crc16" if "--crc" in flags else "judged_shorten"]
    assert results[0].bits == results[0].frames * k
    cfg = SimConfig.from_sources(None, ["channel.crc=crc16",
                                        "channel.shorten_blocks=[0]"])
    assert cfg.channel.crc == "crc16" and cfg.channel.shorten_blocks == (0,)
    assert cfg.config_hash() != SimConfig().config_hash()
