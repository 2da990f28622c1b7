"""The registry-wide tools of the port (scripts/torch_tune_registry_knobs.py,
scripts/torch_roofline_audit.py, scripts/torch_irharq.py) against their
JAX-package twins (scripts/tune_registry_knobs.py, roofline_audit.py,
tpu_irharq.py) and the TPU artifacts those wrote: the same cells and
operating points, the audit's fit reproducing artifacts/roofline_audit.csv
row for row, the HARQ throughput arithmetic reproducing
artifacts/nr1_irharq.json, and both card scripts end to end on the CPU
at a toy size."""

import ast
import csv
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")

torch.set_num_threads(1)


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def constants(name):
    """The module-level literal assignments of a script, read with ast
    (the JAX scripts import JAX and assert a TPU in main)."""
    with open(os.path.join(REPO, "scripts", name + ".py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def load_json(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tuner():
    return load_script("torch_tune_registry_knobs")


@pytest.fixture(scope="module")
def audit():
    return load_script("torch_roofline_audit")


@pytest.fixture(scope="module")
def irharq():
    return load_script("torch_irharq")


# ---- the tuner's cells and settings --------------------------------------

def test_tuner_cells_and_points_equal_the_jax_script(tuner):
    """The TPU artifact's cells, the three the TPU tuned before the
    script (the knob table's 'measured r3' rows) and the judged code, at
    the points the TPU measured them."""
    tpu = load_json("tpu_registry_knobs.json")["cells"]
    with open(os.path.join(REPO, "tpu_ldpc", "codes", "data",
                           "twophase_knobs.json")) as f:
        table = json.load(f)["cells"]
    earlier = {"wifi_r12_z81", "wifi_r56_z81", "wimax_r12_z96"}
    want = {name: rec["ebn0_db"] for name, rec in tpu.items()}
    assert not earlier & set(want)
    want.update({name: table[name]["layered"]["ebn0_db"]
                 for name in earlier | {"qc1024_r12"}})
    got = {code.name: ebn0 for code, ebn0 in tuner.cells()}
    assert len(tuner.cells()) == len(got) == 39
    assert got == want
    # the 37 cells of the JAX script's all_cells(), in its order
    jax_const = constants("tune_registry_knobs")
    assert tuner.EBN0_BY_RATE == jax_const["EBN0_BY_RATE"]
    names = [code.name for code, _ in tuner.cells()]
    assert names[-2:] == ["qc1024_r12", "nr2_r15_z64"]
    assert names[:24] == [f"{fam}_r{r[0]}{r[2]}_z{z}"
                          for fam, lifts in (("wifi", (27, 54, 81)),
                                             ("wimax", (24, 48, 96)))
                          for r in ("1/2", "2/3", "3/4", "5/6")
                          for z in lifts]


def test_tuner_settings_equal_the_jax_script(tuner):
    jax_const = constants("tune_registry_knobs")
    assert (tuner.BATCH, tuner.ITERS) == (jax_const["BATCH"],
                                          jax_const["ITERS"])
    assert (tuner.ALPHA, tuner.FLOOD_ITERS) == (0.75, 50)
    assert tuner.OUT.endswith(os.path.join("artifacts",
                                           "h100_registry_knobs.json"))
    # the single-pass decoders alone: nothing is tuned or probed
    assert not hasattr(tuner, "TUNE_SEED") and not hasattr(tuner,
                                                           "PROBE_SEED")


def toy_tuner(tuner, monkeypatch, batch=16):
    """The tuner cut to one toy cell, `batch` frames and one decode a
    timed run."""
    (cell,) = [c for c in tuner.cells() if c[0].name == "wimax_r56_z24"]
    monkeypatch.setattr(tuner, "cells", lambda: [cell])
    monkeypatch.setattr(tuner, "BATCH", batch)
    monkeypatch.setattr(tuner, "REPS", 1)


def test_tuner_runs_on_the_cpu_and_resumes(tuner, tmp_path, capsys,
                                           monkeypatch):
    toy_tuner(tuner, monkeypatch)
    out = str(tmp_path / "knobs.json")
    argv = ["--device", "cpu", "--out", out]
    assert tuner.main(argv) == 0
    with open(out) as f:
        art = json.load(f)
    row = art["cells"]["wimax_r56_z24"]
    assert art["device"] == "cpu" and art["settings"] == {
        "batch": 16, "iters": 25, "flood_iters": 50, "alpha": 0.75,
        "reps": 1, "coordinates": "plain", "device": "cpu"}
    assert 1 <= row["single_et_mean_iters"] <= tuner.ITERS
    assert set(row) == {"n", "k", "Z", "E", "ebn0_db", "single_et_mean_iters",
                        "wall_s"} | {
        f"{label}_{what}" for label in ("single_et", "layered_etoff",
                                        "flood_etoff")
        for what in ("ms", "dec_ms", "gbps")}
    for label in ("single_et", "layered_etoff", "flood_etoff"):
        assert row[f"{label}_ms"] > 0 and len(row[f"{label}_dec_ms"]) == 5
        assert row[f"{label}_gbps"] == pytest.approx(
            16 * row["k"] / row[f"{label}_ms"] / 1e6)
    # the audit fits the row's ET-off forms
    rows, fits = load_script("torch_roofline_audit").audit(art["cells"])
    assert set(fits) == {"layered_etoff", "flood_etoff"}
    assert [r["fit"] for r in rows] == ["layered_etoff", "flood_etoff"]
    # a rerun resumes: the cell is kept, not measured again
    capsys.readouterr()
    assert tuner.main(argv) == 0
    assert "wimax_r56_z24: done, skip" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f)["cells"]["wimax_r56_z24"] == row


def test_tuner_resume_refuses_other_settings(tuner, tmp_path, monkeypatch):
    """A run with other settings neither mixes its cells into the
    artifact nor rewrites its header."""
    out = tmp_path / "knobs.json"
    toy_tuner(tuner, monkeypatch)
    assert tuner.main(["--device", "cpu", "--out", str(out)]) == 0
    held = out.read_text()
    monkeypatch.setattr(tuner, "BATCH", 8)
    for argv in ([], ["--retune"]):
        with pytest.raises(SystemExit, match="not this run's"):
            tuner.main(["--device", "cpu", "--out", str(out), *argv])
        assert out.read_text() == held


def test_tuner_records_a_refusal_and_raises_the_rest(tuner, tmp_path,
                                                     monkeypatch):
    toy_tuner(tuner, monkeypatch)
    out = str(tmp_path / "knobs.json")
    argv = ["--device", "cpu", "--out", out]

    def refuse(code):
        raise NotImplementedError("layered kernel: no form for this code")

    monkeypatch.setattr(tuner, "build_decoders", refuse)
    assert tuner.main(argv) == 0
    with open(out) as f:
        row = json.load(f)["cells"]["wimax_r56_z24"]
    assert row == {"skipped": "NotImplementedError: layered kernel: no "
                              "form for this code"}

    def fault(code):
        raise RuntimeError("not a refusal")

    monkeypatch.setattr(tuner, "build_decoders", fault)
    with pytest.raises(RuntimeError, match="not a refusal"):
        tuner.main(argv + ["--retune"])


# ---- the audit -------------------------------------------------------------

def test_audit_reproduces_the_tpu_csv(audit, tmp_path):
    """On the TPU's knob artifact the port's audit writes
    artifacts/roofline_audit.csv's rows, column for column."""
    out = str(tmp_path / "audit.csv")
    assert audit.main(["--knobs", os.path.join(ART, "tpu_registry_knobs.json"),
                       "--out", out]) == 0
    with open(os.path.join(ART, "roofline_audit.csv")) as f:
        want = list(csv.DictReader(f))
    with open(out) as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(want) == 35
    for g, w in zip(got, want):
        assert {k: g[k] for k in w} == w
        assert g["fit"] == "twophase" and int(g["bucket"]) in (0, 8, 16, 32)
    # the TPU fit's constants are the roofline audit's round-5 findings
    _, fits = audit.audit(load_json("tpu_registry_knobs.json")["cells"])
    c1, c2, c3 = 1e12 * fits["twophase"][0]
    assert (round(c1, 2), round(c2, 2), round(c3, 3)) == (4.56, 1.78, 0.13)


def test_audit_fits_each_form_with_exact_edge_iterations(audit):
    """ET-off rows cost exactly E * iters edge-iterations a frame; each
    form gets its own fit; the bucket is the plan's form."""
    from tpu_ldpc_torch.decode.flood_plan import flood_plan
    from tpu_ldpc_torch.decode.normalize import coordinates

    cells = {
        "wimax_r56_z24": {"K": 6, "budget": 1024,
                          "layered_twophase_gbps": 2.0,
                          "layered_etoff_gbps": 3.0,
                          "flood_etoff_gbps": 1.0},
        "nr1_r12_z64": {"K": 10, "budget": 512,
                        "layered_twophase_gbps": 1.5,
                        "layered_etoff_gbps": 2.5,
                        "flood_etoff_gbps": 0.5},
        "wifi_r12_z27": {"K": 10, "budget": 896,
                         "layered_twophase_gbps": 1.0,
                         "layered_etoff_gbps": 2.0,
                         "flood_etoff_gbps": 0.7},
        "wimax_r12_z96": {"skipped": "ValueError: refused"},
    }
    rows, fits = audit.audit(cells)
    assert set(fits) == {"twophase", "layered_etoff", "flood_etoff"}
    assert all(len(ok) == 3 for _, ok in fits.values())
    skipped = [r for r in rows if "note" in r]
    assert skipped == [{"cell": "wimax_r12_z96", "fit": "twophase",
                        "note": "ValueError: refused"}]
    for r in rows:
        if r.get("fit") in ("layered_etoff", "flood_etoff"):
            iters = 25 if r["fit"] == "layered_etoff" else 50
            assert r["edge_iters_per_frame"] == r["E_lifted"] * iters
            assert (r["K"], r["budget"]) == (iters, 0)
        if r.get("fit") == "flood_etoff":
            code = audit.build_cell(r["cell"])
            assert r["bucket"] == flood_plan(
                code, coordinates(code, False)[0]).bucket
    assert {r["bucket"] for r in rows if r.get("fit") == "flood_etoff"
            and r["cell"] == "nr1_r12_z64"} == {0}  # the two-pass form


def test_audit_slot_fit(audit):
    """ps/edge exactly a + b * bucket / rowdeg is recovered; bucket-0
    rows are left out, and fewer than three slot rows give no fit."""
    rows = [{"bucket": b, "row_degree": d, "ps_per_edge": 0.5 + 2.0 * b / d}
            for b, d in ((8, 6.4), (16, 8.0), (32, 8.04), (16, 20.0))]
    rows.append({"bucket": 0, "row_degree": 40.0, "ps_per_edge": 99.0})
    a, b, corr, resid = audit.slot_fit(rows)
    assert (a, b) == (pytest.approx(0.5), pytest.approx(2.0))
    assert corr == pytest.approx(1.0) and resid == pytest.approx(0, abs=1e-9)
    assert audit.slot_fit(rows[:2] + rows[4:]) is None


# ---- the HARQ twin ---------------------------------------------------------

def test_harq_ladders_equal_the_jax_script(irharq):
    jax_const = constants("tpu_irharq")
    assert irharq.LADDERS == jax_const["LADDERS"]
    assert (irharq.BATCH, irharq.ITERS, irharq.MIN_OCC) == (
        jax_const["BATCH"], jax_const["ITERS"], jax_const["MIN_OCC"])
    from tpu_ldpc_torch.codes.nrlike import KB, KB2

    # the first transmission's payload rate of tpu_irharq.py:93-95
    assert irharq.first_rate(KB, (7, 10), 64) == (KB * 64 - 24) / (
        (KB + 7 - 2) * 64)
    assert irharq.first_rate(KB2, (7, 12), 64) == (KB2 * 64 - 24) / (
        (KB2 + 7 - 2) * 64)


def test_harq_throughput_reproduces_the_tpu_artifact(irharq):
    art = load_json("nr1_irharq.json")
    n = 0
    for lad in art["ladders"].values():
        for point in lad["points"]:
            got = irharq.throughput(point["stage_timing"],
                                    point["residual_fer"],
                                    point["k_payload"])
            for key, value in got.items():
                assert value == pytest.approx(point[key], rel=1e-12), key
            n += 1
    assert n == 6
    # an untimed stage: below MIN_OCC only the full vector goes
    timing = [{"occ": 1.0, "s_per_frame": 1e-6}, {"occ": 1e-4}]
    got = irharq.throughput(timing, 0.0, 1000)
    assert got["eff_info_gbps_full_vector"] is None
    assert got["eff_info_gbps_active_batching"] == pytest.approx(1.0)
    timing[1]["occ"] = 0.01
    assert irharq.throughput(timing, 0.0, 1000)[
        "eff_info_gbps_active_batching"] is None


def test_irharq_runs_on_the_cpu(irharq, tmp_path, monkeypatch):
    """The toy ladder end to end: run_irharq's stages field for field,
    every stage timed at the HARQ channel."""
    from tpu_ldpc_torch.sim.harq import run_irharq

    monkeypatch.setattr(irharq, "LADDERS", {
        1: {**irharq.LADDERS[1], "points": (4.0,)}})
    monkeypatch.setattr(irharq, "Z", 16)
    monkeypatch.setattr(irharq, "BATCH", 32)
    monkeypatch.setattr(irharq, "REPS", 1)
    out = str(tmp_path / "harq.json")
    assert irharq.main(["--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        art = json.load(f)
    assert (art["Z"], art["batch"], art["reps"]) == (16, 32, 1)
    assert list(art["ladders"]) == ["bg1"]
    (point,) = art["ladders"]["bg1"]["points"]
    want = run_irharq(Z=16, stage_m=(7, 10, 13, 24), ebn0_db=4.0, batch=32,
                      iters=50, seed=0, bg=1, crc="crc24", device="cpu")
    assert point["stages"] == want.stages
    assert point["residual_fer"] == want.residual_fer
    assert [s["m"] for s in point["stage_timing"]] == [7, 10, 13, 24]
    occ = [1.0] + [s["fer_after"] for s in want.stages[:-1]]
    assert [s["occ"] for s in point["stage_timing"]] == occ
    assert all(s["s_per_frame"] > 0 for s in point["stage_timing"])
    assert point["eff_info_gbps_full_vector"] == pytest.approx(
        irharq.throughput(point["stage_timing"], point["residual_fer"],
                          point["k_payload"])["eff_info_gbps_full_vector"])
    assert np.isfinite(point["eff_info_gbps_active_batching"])


def test_stage_timer_erases_the_punctured_pair(irharq):
    stages = irharq.StageTimer(1, (7, 10), 16, 8, torch.device("cpu"), 1)
    seen = []
    stages._dec[0] = lambda llr: seen.append(llr)
    from tpu_ldpc_torch.benchcore import make_timer

    stages._timer[0] = make_timer(stages.codes[0], 8, 2.0, device="cpu",
                                  n_punct=32)
    stages.cost(0, 3.0)
    from tpu_ldpc_torch.channel.awgn import noise_sigma2

    sigma2 = noise_sigma2(3.0, irharq.first_rate(stages.kb, (7, 10), 16))
    timer = stages._timer[0]
    want = (2.0 / sigma2) * (timer.xs[0] + float(np.sqrt(sigma2))
                             * timer.noises[0])
    want[:, :32] = 0.0
    assert torch.equal(seen[0], want)
