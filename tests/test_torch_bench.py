"""The port's throughput benchmark (cli/bench.py, benchcore.py) against
the JAX package's on the CPU.

The timed decoder is held bit for bit against the JAX package's jnp
decoder (the path tpu_ldpc/cli/bench.py takes on the CPU) on the same
NumPy-seeded LLRs; the record's static fields against
tpu_ldpc.cli.bench.main's for the same flags.  Times are not compared:
the CPU's numbers measure nothing of the card.
"""

import json
import math

import numpy as np
import pytest
import torch

import tpu_ldpc.cli.bench as jax_bench
from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import make_base_graph
from tpu_ldpc.decode.reference import build_decoder as jnp_build_decoder
from tpu_ldpc.golden import encode as golden_encode
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch import benchcore
from tpu_ldpc_torch.benchcore import LoopTimer, default_buffers, make_timer
from tpu_ldpc_torch.cli import bench
from tpu_ldpc_torch.cli.bench import bench_decode, build_bench_decoder, main

torch.set_num_threads(1)

STATIC = ("code", "n", "k", "ebn0_db", "algo", "iters", "schedule",
          "early_stop", "batch")
JAX_KEYS = STATIC + ("backend", "n_devices", "ms_per_batch",
                     "info_bits_per_s", "gbps")


def codes(name):
    """(the JAX package's code, its port twin)."""
    ref = (JaxLdpcCode.judged() if name == "judged"
           else JaxLdpcCode.from_base_graph(make_base_graph(4, 8, 8, seed=7),
                                            8, "toy8"))
    return ref, LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)


def noisy_llrs(code, batch, ebn0_db, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    c = golden_encode(code.H, u)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("algo,schedule", [
    ("minsum", "flooding"), ("minsum", "layered"),
    ("sumproduct-fast", "flooding")])
def test_bench_decoder_matches_jax(algo, schedule, early_stop):
    ref, code = codes("toy")
    llr = noisy_llrs(ref, 96, 2.0, seed=11)
    got = build_bench_decoder(code, iters=8, algo=algo, schedule=schedule,
                              early_stop=early_stop, device="cpu")(
        torch.from_numpy(llr))
    want = jnp_build_decoder(ref, algo=algo, iters=8, alpha=0.75,
                             schedule=schedule, early_stop=early_stop)(llr)
    for g, w, what in zip(got, want, ("bits", "ok", "iters_used")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), what)
    ok, iu = got[1].numpy(), got[2].numpy()
    assert 0 < ok.sum() < len(ok)  # converged and failed frames alike
    if early_stop:
        assert iu.min() < 8
    else:
        assert (iu == 8).all()


def one_json_line(capsys):
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1, out

    def refuse(constant):
        raise ValueError(f"non-strict JSON constant {constant}")

    return json.loads(out[0], parse_constant=refuse)


def test_main_json_record(capsys):
    rec = main(["--batch", "64", "--iters", "4", "--reps", "2", "--json",
                "--device", "cpu"])
    assert one_json_line(capsys) == rec
    assert set(rec) == set(JAX_KEYS) | {"device_kind"}
    assert rec["backend"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["n"] == 1024 and rec["k"] == 512
    assert rec["ms_per_batch"] > 0 and math.isfinite(rec["gbps"])
    assert rec["info_bits_per_s"] == pytest.approx(
        64 * 512 / (rec["ms_per_batch"] / 1e3), rel=1e-12)


@pytest.mark.parametrize("flags", [
    ["--batch", "64", "--iters", "4"],
    ["--algo", "sumproduct-fast", "--early-stop", "--ebn0", "1.5"],
], ids=["default", "spfast-et"])
def test_static_fields_match_jax(flags, monkeypatch, capsys):
    """The same flags give the JAX record's static fields; the timed
    call is stubbed in both packages (its arguments are compared: the
    JAX package's two-phase knobs, which the port does not have, are
    unset there)."""
    seen = {}

    def fake(pkg):
        def bench_decode(code, **kw):
            seen[pkg] = kw
            return 1e-3, 1e9
        return bench_decode

    monkeypatch.setattr(jax_bench, "bench_decode", fake("jax"))
    monkeypatch.setattr(bench, "bench_decode", fake("port"))
    want = jax_bench.main(flags + ["--json"])
    capsys.readouterr()
    got = main(flags + ["--json", "--device", "cpu"])
    assert one_json_line(capsys) == got
    assert {k: got[k] for k in STATIC} == {k: want[k] for k in STATIC}
    assert set(got) == set(want) | {"device_kind"}
    port_kw, jax_kw = dict(seen["port"]), dict(seen["jax"])
    assert port_kw.pop("device") == torch.device("cpu")
    assert port_kw.pop("profile") is None
    assert jax_kw.pop("phase1_iters") is None
    assert jax_kw.pop("compact_budget") is None
    assert port_kw == jax_kw


@pytest.mark.parametrize("flags,words", [
    (["--impl", "twophase"], "invalid choice: 'twophase'"),
    (["--compact-budget", "768"], "unrecognized arguments: --compact-budget"),
], ids=["impl-twophase", "compact-budget"])
def test_main_refuses_twophase(flags, words, capsys):
    """Two-phase decoding is not in the port: its impl and its knobs
    are refused by the parser, before anything is built or timed."""
    with pytest.raises(SystemExit) as e:
        main(flags + ["--device", "cpu", "--json"])
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert words in captured.err and captured.out == ""


def test_loop_timer_measures_real_work():
    """A 30-iteration decode measures longer than a 2-iteration one."""
    _, code = codes("toy")
    timer = make_timer(code, 64, device="cpu")
    light = build_bench_decoder(code, iters=2, device="cpu")
    heavy = build_bench_decoder(code, iters=30, device="cpu")
    ml = timer.measure(light, reps=1)
    mh = timer.measure(heavy, reps=1)
    assert set(ml) == {"median_s", "best_s", "dec_ms"}
    assert len(ml["dec_ms"]) == benchcore.REPEATS
    assert all(t > 0 for t in ml["dec_ms"])
    assert mh["median_s"] > ml["median_s"] > 0
    assert ml["best_s"] <= ml["median_s"]


def test_timer_buffers_distinct_codewords():
    """The buffers are pairwise distinct noisy codewords: at 8 dB every
    frame of every buffer decodes."""
    _, code = codes("toy")
    timer = make_timer(code, 32, 8.0, device="cpu", n_buffers=5, seed=3)
    assert len(timer.llrs) == 5
    for i, a in enumerate(timer.llrs):
        assert a.shape == (32, code.n) and a.dtype == torch.float32
        for b in timer.llrs[i + 1:]:
            assert not torch.equal(a, b)
        assert build_bench_decoder(code, iters=8, early_stop=True,
                                   device="cpu")(a)[1].all()
    assert len(make_timer(code, 32, device="cpu").llrs) == (
        benchcore.CPU_BUFFERS)


def test_default_buffers_exceed_l2(monkeypatch):
    class Props:
        L2_cache_size = 50 * 2**20

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    cuda = torch.device("cuda")
    judged_b4096 = 4096 * 1024 * 4  # 16 MiB
    assert default_buffers(judged_b4096, cuda) == 4
    assert 4 * judged_b4096 > Props.L2_cache_size
    assert default_buffers(64 * 2**20, cuda) == 2
    assert default_buffers(4096, cuda) == benchcore.MAX_BUFFERS
    assert default_buffers(judged_b4096, torch.device("cpu")) == 4


def test_nan_time_writes_null(monkeypatch, capsys):
    monkeypatch.setattr(LoopTimer, "measure",
                        lambda self, fn, reps=30: {"median_s": 0.0})
    _, code = codes("toy")
    dt, thpt = bench_decode(code, batch=8, iters=2, device="cpu")
    assert math.isnan(dt) and math.isnan(thpt)
    assert "not a positive time" in capsys.readouterr().err
    monkeypatch.setattr(bench, "bench_decode",
                        lambda code, **kw: (float("nan"), float("nan")))
    rec = main(["--json", "--device", "cpu"])
    line = one_json_line(capsys)
    for key in ("ms_per_batch", "info_bits_per_s", "gbps"):
        assert line[key] is None and math.isnan(rec[key])


def test_device_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--json"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        main(["--impl", "cuda", "--device", "cpu", "--json"])
    for impl in ("jnp", "pallas"):
        with pytest.raises(NotImplementedError, match="counterpart"):
            main(["--impl", impl, "--device", "cpu", "--json"])


def test_profile_writes_trace(tmp_path):
    _, code = codes("toy")
    dt, _ = bench_decode(code, batch=8, iters=2, reps=1, device="cpu",
                         profile=str(tmp_path))
    assert dt > 0
    with open(tmp_path / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert "ldpc.decode" in {e.get("name") for e in events}


def test_early_stop_off_only_for_bp():
    """build_decode_fn(early_stop=False) runs every iteration on the BP
    decoders and refuses the decoders that do not take it."""
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.sim.mc import DecodeCfg

    _, code = codes("toy")
    llr = torch.full((4, code.n), 6.0)
    for impl in ("auto", "torch"):
        fn = build_decode_fn(code, DecodeCfg(iters=5, impl=impl), "cpu",
                             early_stop=False)
        assert (fn(llr)[2] == 5).all()
    assert (build_decode_fn(code, DecodeCfg(iters=5), "cpu")(llr)[2]
            == 0).all()
    for cfg in (DecodeCfg(algo="wbf"), DecodeCfg(schedule="windowed")):
        with pytest.raises(ValueError, match="early_stop=False"):
            build_decode_fn(code, cfg, "cpu", early_stop=False)
