"""Port Monte-Carlo harness, checkpoint state and CLI vs the JAX package.

The port's generators are PyTorch's, not JAX's Threefry, so its runs
cannot match the JAX harness draw for draw.  The counting is compared on
injected inputs instead: the same u and noise go through the port's
BatchFn.batch_counters and through a composition of the JAX package's
encoder, channel, jnp reference decoder and counter lines (sim/mc.py
build_batch_fn), and all six counters must be identical.  The port runs
its own LdpcCode, built from the JAX package's through
LdpcCode.from_base_graph.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ldpc.channel.awgn import bpsk as jax_bpsk
from tpu_ldpc.channel.awgn import noise_sigma2 as jax_noise_sigma2
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.encode.encoder import build_encoder as jax_build_encoder
from tpu_ldpc.sim.mc import SnrResult as JaxSnrResult
from tpu_ldpc.sim.state import SweepState as JaxSweepState
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.cli.config import CodeSpec, SimConfig
from tpu_ldpc_torch.sim.mc import (
    COUNTER_FIELDS, DecodeCfg, build_batch_fn, build_mc_step, run_ber)
from tpu_ldpc_torch.sim.state import SweepState

torch.set_num_threads(1)


def twin(ref):
    return LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def toy_code():
    return twin(JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 4, seed=7),
                                            4, "toy"))


def jax_counters(code, cfg, u, noise, ebn0_db):
    """The JAX package's per-batch counting on given u and noise."""
    code = JaxLdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)
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
    ("toy", 1.5, 64), ("judged", 1.0, 16), ("toy_layered", 1.5, 64),
    ("toy_sumproduct", 1.5, 64)])
def test_batch_counters_match_jax(name, ebn0_db, batch):
    code = twin(JaxLdpcCode.judged()) if name == "judged" else toy_code()
    cfg = DecodeCfg(iters=20, schedule="layered" if "layered" in name
                    else "flooding",
                    algo="sumproduct" if "sumproduct" in name else "minsum")
    rng = np.random.default_rng(17)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    noise = rng.normal(size=(batch, code.n)).astype(np.float32)
    fn = build_batch_fn(code, cfg, batch, device="cpu")
    got = fn.batch_counters(torch.from_numpy(u), torch.from_numpy(noise),
                            ebn0_db)
    assert got.dtype == torch.int64 and got.shape == (len(COUNTER_FIELDS),)
    want = jax_counters(code, cfg, u, noise, ebn0_db)
    if cfg.algo == "minsum":
        np.testing.assert_array_equal(got.numpy(), want)
    else:  # transcendentals: frame-level agreement, counters within 3%
        np.testing.assert_allclose(got.numpy(), want, rtol=0.03)
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


def flip_bits(gen, bits, ok, iters_used):
    """Fault: flip each decoded bit with probability 0.05."""
    flip = torch.rand(bits.shape, generator=gen, device=bits.device) < 0.05
    return bits ^ flip.to(torch.uint8), ok, iters_used


def with_fault_hook(hook, build):
    """build() under sim/mc.py's _FAULT_HOOK, the step caches cleared
    before and after (the hook is read when a BatchFn is built)."""
    import importlib

    mc = importlib.import_module("tpu_ldpc_torch.sim.mc")
    mesh = importlib.import_module("tpu_ldpc_torch.dist.mesh")
    mc._FAULT_HOOK = hook
    mc._build_mc_step.cache_clear()
    mesh.build_sharded_mc_step.cache_clear()
    try:
        return build()
    finally:
        mc._FAULT_HOOK = None
        mc._build_mc_step.cache_clear()
        mesh.build_sharded_mc_step.cache_clear()


@pytest.mark.parametrize("where", ["single", "sharded_world1"])
def test_fault_injection_detected(where, monkeypatch):
    """Port of tests/test_ber.py::test_fault_injection_detected: a
    corrupted decode shows in the counters (frame errors and undetected
    errors rise; the accounting stays consistent), on the single-device
    step and on the sharded step of a world-1 gloo group."""
    import torch.distributed as dist

    from tpu_ldpc_torch.dist.mesh import (
        build_sharded_mc_step, init_distributed, make_mesh)

    code = toy_code()
    cfg = DecodeCfg(algo="minsum", iters=20)
    mesh = None
    if where == "sharded_world1":
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        init_distributed(device="cpu")
        mesh = make_mesh()

    def run_step():
        if mesh is None:
            step = build_mc_step(code, cfg, 64, device="cpu")
        else:
            step = build_sharded_mc_step(code, cfg, 64, mesh)
        return step(1, 0, 8.0, 0).numpy()

    try:
        clean = run_step()
        faulty = with_fault_hook(flip_bits, run_step)
        again = run_step()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    np.testing.assert_array_equal(again, clean)  # the hook is gone
    assert faulty[0] == clean[0] == 64
    assert faulty[1] > clean[1]          # bit errors jump
    assert faulty[2] > clean[2]          # frame errors jump
    assert faulty[4] >= clean[4]         # corrupted-but-"ok" frames counted
    assert faulty[2] <= faulty[3] + faulty[4]  # accounting invariant


def test_crc_gating_catches_injected_fault():
    """Port of tests/test_crc.py::test_crc_gating_catches_injected_fault:
    one payload bit flipped in every decoded frame; the outer CRC reports
    every frame as detected (no false ACKs)."""
    code = twin(JaxLdpcCode.from_base_graph(
        make_base_graph(4, 12, 4, seed=5), 8, "crc_toy"))  # n=96, k=64
    cfg = DecodeCfg(algo="minsum", iters=20)

    def flip_hook(gen, bits, ok, iters_used):
        bits = bits.clone()
        bits[:, 3] = 1 - bits[:, 3]
        return bits, ok, iters_used

    counters = with_fault_hook(flip_hook, lambda: build_mc_step(
        code, cfg, 64, 1, None, "crc16", device="cpu")(0, 0, 8.0, 0))
    frames, _, frame_errors, detected, undetected, _ = counters.tolist()
    assert frame_errors == frames == 64  # every payload genie-wrong
    assert detected == frames            # ...and every one CRC-detected
    assert undetected == 0


def test_fault_hook_argument_leaves_the_draw():
    """fault_hook= of build_batch_fn: the hook sees the batch's own
    generator after the draw, so u and noise are the hook-free batch's;
    the identity hook leaves the counters unchanged."""
    code = toy_code()
    cfg = DecodeCfg(iters=10)
    seen = []

    def identity(gen, bits, ok, iters_used):
        seen.append(gen)
        return bits, ok, iters_used

    plain = build_batch_fn(code, cfg, 32, device="cpu")
    hooked = build_batch_fn(code, cfg, 32, device="cpu", fault_hook=identity)
    assert plain.fault_hook is None and hooked.fault_hook is identity
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    assert torch.equal(plain(gens[0], 2.0), hooked(gens[1], 2.0))
    assert seen == [gens[1]]
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


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
    "wbf", "bitflip", "windowed", "jnp", "nr", "mesh", "profile",
    "twophase"])
def test_unsupported_modes_raise(what, tmp_path, monkeypatch):
    from tpu_ldpc_torch.cli.sim import main

    if what == "nr":
        # ported since (it raised before rate adaptation existed): the
        # NR-like code builds and runs a punctured run_ber point
        from tpu_ldpc_torch.cli.config import ChannelCfg

        code = CodeSpec(family="nr", rate="1/2", Z=32).build()
        adapt = ChannelCfg().build_adapt(code)
        assert code.name == "nr1_r12_z32" and len(adapt.puncture) == 64
        res = run_ber(code, [1.5], DecodeCfg(iters=10), batch=8,
                      max_frames=8, adapt=adapt, device="cpu")[0]
        assert res.frames == 8 and res.bits == 8 * code.k
        return
    if what in ("wbf", "bitflip", "windowed"):
        # ported since (they raised before the hard-decision and windowed
        # decoders existed in the port): run_ber counts their frames
        if what == "windowed":
            code = CodeSpec(family="sc", L=8, Z=8).build()
            cfg = DecodeCfg(iters=2, schedule="windowed", window=5)
        else:
            code, cfg = toy_code(), DecodeCfg(algo=what, iters=10)
        res = run_ber(code, [6.0], cfg, batch=8, max_frames=16,
                      device="cpu")[0]
        assert res.frames == 16 and res.bits == 16 * res_k(code)
        assert res.fer < 0.5
        if what == "windowed":  # no early termination: every slide runs
            assert res.iter_sum == 16 * 2 * (code.mb - 5 + 1)
        else:
            assert res.iter_sum <= 16 * 10
        return
    if what in ("mesh", "profile"):
        # ported since (both raised before slice 10): --mesh sweeps over a
        # group of one made in this process (no torchrun), --profile
        # writes a Chrome trace
        import torch.distributed as dist

        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        trace = tmp_path / "prof"
        flag = {"mesh": ["--mesh"], "profile": ["--profile", str(trace)]}[what]
        try:
            res = main(["--family", "judged", "--device", "cpu", "--ebn0",
                        "3.0", "--batch", "8", "--max-frames", "8",
                        "--iters", "5", *flag])
            assert dist.is_initialized() == (what == "mesh")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        assert [r.frames for r in res] == [8]
        if what == "profile":
            assert (trace / "trace_rank0.json").stat().st_size > 1000
        return
    # an impl the port does not have: run_ber refuses it, naming the
    # counterpart
    counterpart = {"jnp": "impl='torch'", "twophase": "impl='auto'"}[what]
    with pytest.raises(NotImplementedError, match=counterpart):
        run_ber(toy_code(), [2.0], DecodeCfg(impl=what), batch=8,
                max_frames=8, device="cpu")


def res_k(code):
    """Info bits a frame: the true dimension (the pivot encoder's)."""
    from tpu_ldpc_torch.encode.encoder import select_encoder

    return select_encoder(code, device="cpu")[1]


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


@pytest.mark.parametrize("flags", [
    ["--schedule", "layered"],
    ["--algo", "sumproduct"],
    ["--algo", "sumproduct-fast"],
    ["--quant-bits", "5", "--quant-step", "0.5"],
    ["--algo", "sumproduct-fast", "--find-fer", "0.5", "--ebn0", "0.0",
     "3.0"],
], ids=["layered", "sumproduct", "sumproduct-fast", "quant", "find_fer"])
def test_sim_cli_decoder_modes(tmp_path, capsys, flags):
    """The modes slices 2 and 3 ported (they raised before) run end to
    end through the CLI and land in the config hash; --find-fer bisects
    between min and max of --ebn0 instead of sweeping."""
    from tpu_ldpc_torch.cli.sim import main

    common = ["--family", "judged", "--iters", "10", "--device", "cpu",
              "--batch", "16", "--target-fe", "5"]
    if "--find-fer" in flags:
        sr = main([*common, *flags])
        out = capsys.readouterr().out
        assert "Eb/N0 @ FER 5.00e-01" in out and "converged" in out
        assert sr.converged and sr.target_fer == 0.5
        lo, hi = sr.bracket
        assert 0.0 <= lo < sr.ebn0_db < hi <= 3.0 and hi - lo <= 0.1
        assert [p.ebn0_db for p in sr.probes[:3]] == [0.0, 3.0, 1.5]
        assert sr.probes[0].fer >= 0.5 >= sr.probes[1].fer
        return
    csv = str(tmp_path / "out.csv")
    results = main([*common, "--ebn0", "1.5", "--max-frames", "32",
                    "--csv", csv, *flags])
    out = capsys.readouterr().out
    assert f"schedule={'layered' if 'layered' in flags else 'flooding'}" in out
    assert results[0].frames >= 16 and results[0].frame_errors > 0
    row = dict(zip(*(ln.split(",") for ln in
                     open(csv).read().strip().splitlines()[1:3])))
    assert int(row["frames"]) == results[0].frames
    cfg = SimConfig.from_sources(None, [f"decode.{k}" for k in (
        "schedule=layered", "impl=torch")])
    assert cfg.decode.impl == "torch"
    assert cfg.config_hash() != SimConfig.from_sources(
        None, ["decode.schedule=layered"]).config_hash()
    quant = SimConfig.from_sources(None, ["decode.quant_bits=5",
                                          "decode.quant_step=0.25"])
    assert quant.decode.quant_step == 0.25
    assert quant.config_hash() != SimConfig.from_sources(
        None, ["decode.quant_bits=5"]).config_hash()


@pytest.mark.parametrize("flags,words", [
    (["--impl", "twophase"], "invalid choice: 'twophase'"),
    (["--phase1-iters", "9"], "unrecognized arguments: --phase1-iters"),
], ids=["impl-twophase", "phase1-iters"])
def test_sim_cli_refuses_twophase(flags, words, capsys):
    """Two-phase decoding is not in the port: the parser refuses its impl
    and its knobs before anything runs."""
    from tpu_ldpc_torch.cli.sim import main

    with pytest.raises(SystemExit) as e:
        main(["--family", "judged", "--ebn0", "2.0", "--device", "cpu",
              *flags])
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert words in captured.err and captured.out == ""


def test_config_file_refuses_twophase_knobs(tmp_path):
    """A config file that sets a two-phase knob is refused as any unknown
    key is, through the CLI's --config."""
    from tpu_ldpc_torch.cli.sim import main

    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({"decode": {"schedule": "layered",
                                           "phase1_iters": 9}}))
    with pytest.raises(ValueError,
                       match="unknown config key 'phase1_iters'"):
        main(["--config", str(path), "--family", "judged", "--ebn0", "2.0",
              "--device", "cpu", "--max-frames", "8"])


def test_config_hash_and_overrides():
    a = SimConfig.from_sources(None, ["decode.alpha=0.8", "run.device=cpu"])
    assert a.decode.alpha == 0.8 and a.run.device == "cpu"
    assert a.config_hash() == SimConfig.from_sources(
        None, ["run.device=cpu", "decode.alpha=0.8"]).config_hash()
    assert a.config_hash() != SimConfig().config_hash()
    # decode.window exists since the windowed decoder was ported
    assert SimConfig.from_sources(
        None, ["decode.window=4"]).decode.window == 4
    with pytest.raises(ValueError, match="unknown config key"):
        SimConfig.from_sources(None, ["decode.windows=4"])
