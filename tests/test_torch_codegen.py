"""The port's construction CLI (`python -m tpu_ldpc_torch.cli.codegen`),
its registry report and waterfall plot against the JAX package's: the
same argv prints the same lines and writes the same files."""

import os

import numpy as np
import pytest

from tpu_ldpc.cli import codegen as jax_codegen
from tpu_ldpc.codes import base_graphs as jax_bg
from tpu_ldpc_torch.cli import codegen
from tpu_ldpc_torch.codes import base_graphs as bg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_both(capsys, tmp_path, argv):
    """(port stdout, JAX stdout, port dir, JAX dir); {out} in argv is the
    output directory of each run."""
    texts, dirs = [], []
    for name, main in (("port", codegen.main), ("jax", jax_codegen.main)):
        d = tmp_path / name
        d.mkdir()
        main([a.replace("{out}", str(d)) for a in argv])
        texts.append(capsys.readouterr().out.replace(str(d), "{out}"))
        dirs.append(d)
    return texts[0], texts[1], dirs[0], dirs[1]


@pytest.mark.parametrize("argv", [
    ["--family", "custom", "--mb", "4", "--nb", "8", "--z", "8",
     "--out", "{out}/c.qc"],
    ["--family", "custom", "--mb", "3", "--nb", "6", "--z", "8",
     "--pexit", "15", "--anneal", "50", "--ace", "--threshold",
     "--out", "{out}/p.qc"],
    ["--family", "custom", "--mb", "4", "--nb", "8", "--z", "8",
     "--seed", "3", "--anneal", "60", "--dmin", "6", "--dmin-qc",
     "--alist", "{out}/c.alist"],
    ["--family", "custom", "--mb", "4", "--nb", "6", "--z", "4",
     "--seed", "5", "--dmin", "3"],
    ["--family", "nr2", "--rate", "1/5", "--z", "4",
     "--out", "{out}/nr2.qc", "--alist", "{out}/nr2.alist"],
    ["--family", "wimax", "--rate", "5/6", "--z", "24", "--dmin", "2"],
], ids=["custom", "pexit_anneal_ace", "dmin_qc_alist", "dmin_exact",
        "nr2", "wimax"])
def test_cli_equals_jax(capsys, tmp_path, argv):
    got, want, d_port, d_jax = run_both(capsys, tmp_path, argv)
    assert got == want
    assert "girth>=" in got
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_jax))
    for name in os.listdir(d_jax):
        assert (d_port / name).read_bytes() == (d_jax / name).read_bytes()


def test_registry_report_equals_jax(capsys, tmp_path, monkeypatch):
    """The registry report over the judged code and the Z=27 / Z=24
    cells: the same file as the JAX package's, and the rows of
    judged, wifi_r34_z27 and wimax_r56_z24 as in
    artifacts/construction_report.md."""
    for mod in (bg, jax_bg):
        monkeypatch.setattr(mod, "FAMILY_LIFTS",
                            {"wifi": (27,), "wimax": (24,)})
    codegen.main(["--registry-report", str(tmp_path / "port.md")])
    got = capsys.readouterr().out
    jax_codegen.registry_report(str(tmp_path / "jax.md"))
    want = capsys.readouterr().out
    assert got.replace("port.md", "jax.md") == want
    text = (tmp_path / "port.md").read_text()
    assert text == (tmp_path / "jax.md").read_text()
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")][1:]
    assert len(rows) == 9
    with open(os.path.join(REPO, "artifacts", "construction_report.md")) as f:
        frozen = f.read().splitlines()
    for name in ("qc1024_r12", "wifi_r34_z27", "wimax_r56_z24"):
        row = next(ln for ln in rows if ln.startswith(f"| {name} |"))
        assert row in frozen, row
    assert "| wifi_r34_z27 | 648 | 486 | 0.750 | 27 | 2.18 | >=6 | 195 " \
           "| 4.953 | 8613 | 59.95 |" in rows
    assert "| wimax_r56_z24 | 576 | 480 | 0.833 | 24 | 2.86 | >=6 | 209 " \
           "| 23.281 | 7714 | 409.09 |" in rows


def test_plot_waterfall(tmp_path):
    from tpu_ldpc_torch.report.plots import plot_waterfall
    from tpu_ldpc_torch.sim.mc import SnrResult

    rs = [SnrResult(ebn0_db=1.0, frames=100, frame_errors=50,
                    bit_errors=300),
          SnrResult(ebn0_db=2.0, frames=100, frame_errors=5, bit_errors=20)]
    out = plot_waterfall({"toy": rs, "ber": rs}, str(tmp_path / "w.png"),
                         metric="ber")
    assert out == str(tmp_path / "w.png")
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert np.isfinite([r.ber for r in rs]).all()
