"""Port Monte-Carlo harness, checkpoint state and CLI vs the JAX package.

The port's generators are PyTorch's, not JAX's Threefry, so its runs
cannot match the JAX harness draw for draw.  The counting is compared on
injected inputs instead: the same u and noise go through the port's
BatchFn.batch_counters and through a composition of the JAX package's
encoder, channel, jnp reference decoder and counter lines (sim/mc.py
build_batch_fn), and all six counters must be identical.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.channel.awgn import bpsk as jax_bpsk
from tpu_ldpc.channel.awgn import noise_sigma2 as jax_noise_sigma2
from tpu_ldpc.codes import LdpcCode, make_base_graph
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.encode.encoder import build_encoder as jax_build_encoder
from tpu_ldpc.sim.mc import SnrResult as JaxSnrResult
from tpu_ldpc.sim.state import SweepState as JaxSweepState
from tpu_ldpc_torch.cli.config import CodeSpec, SimConfig
from tpu_ldpc_torch.sim.mc import (
    COUNTER_FIELDS, DecodeCfg, build_batch_fn, build_mc_step, run_ber)
from tpu_ldpc_torch.sim.state import SweepState

torch.set_num_threads(1)


def toy_code():
    return LdpcCode.from_base_graph(make_base_graph(4, 8, 4, seed=7), 4, "toy")


def jax_counters(code, cfg, u, noise, ebn0_db):
    """The JAX package's per-batch counting on given u and noise."""
    c = jax_build_encoder(code, "generator")(u)
    sigma2 = jnp.float32(jax_noise_sigma2(ebn0_db, code.rate))
    llr = (2.0 / sigma2) * (jax_bpsk(c) + jnp.sqrt(sigma2) * noise)
    bits, ok, iters_used = jnp_build_decoder(
        code, cfg.algo, cfg.iters, cfg.alpha, cfg.beta, cfg.schedule)(llr)
    # tpu_ldpc/sim/mc.py:212-231, no adaptation, no CRC
    wrong = bits[:, :code.k] != u
    frame_wrong = jnp.any(wrong, axis=1)
    return np.asarray([
        u.shape[0],
        jnp.sum(wrong),
        jnp.sum(frame_wrong),
        jnp.sum(~ok),
        jnp.sum(ok & frame_wrong),
        jnp.sum(iters_used),
    ], dtype=np.int64)


@pytest.mark.parametrize("name,ebn0_db,batch", [
    ("toy", 1.5, 64), ("judged", 1.0, 16)])
def test_batch_counters_match_jax(name, ebn0_db, batch):
    code = toy_code() if name == "toy" else LdpcCode.judged()
    cfg = DecodeCfg(iters=20)
    rng = np.random.default_rng(17)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    noise = rng.normal(size=(batch, code.n)).astype(np.float32)
    fn = build_batch_fn(code, cfg, batch, device="cpu")
    got = fn.batch_counters(torch.from_numpy(u), torch.from_numpy(noise),
                            ebn0_db)
    assert got.dtype == torch.int64 and got.shape == (len(COUNTER_FIELDS),)
    want = jax_counters(code, cfg, u, noise, ebn0_db)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[2] > 0 and want[3] > 0  # errors were counted


def test_regroup_invariance():
    code = toy_code()
    cfg = DecodeCfg(iters=15)
    one = build_mc_step(code, cfg, 32, 1, device="cpu")
    three = build_mc_step(code, cfg, 32, 3, device="cpu")
    a = sum(one(4, 1, 2.5, t) for t in range(6))
    b = three(4, 1, 2.5, 0) + three(4, 1, 2.5, 3)
    assert torch.equal(a, b)
    assert a[0] == 6 * 32 and a[2] > 0


def test_resume_bit_identical(tmp_path):
    """Interrupted + resumed sweep == uninterrupted sweep."""
    code = toy_code()
    kw = dict(cfg=DecodeCfg(iters=15), batch=32, seed=9, device="cpu")
    full = run_ber(code, [3.0], target_frame_errors=40, max_frames=4096,
                   **kw)[0]
    ckpt = str(tmp_path / "sweep.json")
    run_ber(code, [3.0], target_frame_errors=10, max_frames=4096,
            state=SweepState(ckpt, "h1"), **kw)
    resumed = run_ber(code, [3.0], target_frame_errors=40, max_frames=4096,
                      state=SweepState(ckpt, "h1"), **kw)[0]
    for name in COUNTER_FIELDS:
        assert getattr(resumed, name) == getattr(full, name), name
    assert full.frame_errors >= 40


def test_jax_checkpoint_loads_in_port(tmp_path):
    ckpt = str(tmp_path / "jax_sweep.json")
    res = JaxSnrResult(ebn0_db=2.0, frames=4096, bit_errors=77,
                       frame_errors=12, detected=15, undetected=1,
                       iter_sum=51234, wall_s=1.5)
    JaxSweepState(ckpt, "cafe").save_point(1, res, 16)
    state = SweepState(ckpt, "cafe")
    assert state.load_point(0) is None
    got, batch_ctr = state.load_point(1)
    assert batch_ctr == 16
    for name in COUNTER_FIELDS + ("ebn0_db", "wall_s"):
        assert getattr(got, name) == getattr(res, name), name
    with pytest.raises(ValueError, match="different config"):
        SweepState(ckpt, "beef")
    # the port writes the same schema back
    state.save_point(1, got, batch_ctr + 1)
    assert JaxSweepState(ckpt, "cafe").load_point(1)[1] == 17


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_ber(toy_code(), [2.0], batch=8, max_frames=8, device="cuda")
    from tpu_ldpc_torch.cli.sim import main

    with pytest.raises(RuntimeError, match="is_available"):
        main(["--family", "judged", "--ebn0", "2.0", "--max-frames", "8"])


@pytest.mark.parametrize("what", [
    "layered", "sumproduct", "bitflip", "windowed", "quant", "jnp",
    "nr", "mesh", "find_fer", "profile"])
def test_unsupported_modes_raise(what):
    from tpu_ldpc_torch.cli.sim import main

    if what == "nr":
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            CodeSpec(family="nr", rate="1/2", Z=32).build()
        return
    if what in ("mesh", "find_fer", "profile"):
        flag = {"mesh": ["--mesh"], "find_fer": ["--find-fer", "1e-2"],
                "profile": ["--profile", "p"]}[what]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(["--family", "judged", "--device", "cpu", *flag])
        return
    cfg = {
        "layered": DecodeCfg(schedule="layered"),
        "sumproduct": DecodeCfg(algo="sumproduct"),
        "bitflip": DecodeCfg(algo="bitflip"),
        "windowed": DecodeCfg(schedule="windowed"),
        "quant": DecodeCfg(quant_bits=5),
        "jnp": DecodeCfg(impl="jnp"),
    }[what]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_ber(toy_code(), [2.0], cfg, batch=8, max_frames=8, device="cpu")


def test_sim_cli_end_to_end(tmp_path, capsys):
    from tpu_ldpc_torch.cli.sim import main

    csv = str(tmp_path / "out.csv")
    results = main([
        "--family", "judged", "--ebn0", "1.5", "--iters", "10",
        "--device", "cpu", "--batch", "16", "--target-fe", "5",
        "--max-frames", "32", "--csv", csv,
        "--jsonl", str(tmp_path / "pts.jsonl"),
        "--checkpoint", str(tmp_path / "ck.json"),
    ])
    out = capsys.readouterr().out
    assert "qc1024_r12" in out and "device=cpu" in out
    lines = open(csv).read().strip().splitlines()
    assert lines[0].startswith("# config_hash=")
    row = dict(zip(lines[1].split(","), lines[2].split(",")))
    assert int(row["frames"]) == results[0].frames >= 16
    rec = json.loads(open(tmp_path / "pts.jsonl").read().strip())
    assert rec["frames"] == results[0].frames
    assert os.path.exists(tmp_path / "ck.json")


def test_config_hash_and_overrides():
    a = SimConfig.from_sources(None, ["decode.alpha=0.8", "run.device=cpu"])
    assert a.decode.alpha == 0.8 and a.run.device == "cpu"
    assert a.config_hash() == SimConfig.from_sources(
        None, ["run.device=cpu", "decode.alpha=0.8"]).config_hash()
    assert a.config_hash() != SimConfig().config_hash()
    with pytest.raises(ValueError, match="unknown config key"):
        SimConfig.from_sources(None, ["decode.window=4"])
