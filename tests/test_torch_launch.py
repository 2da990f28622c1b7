"""The port's launcher and the sweep CLI's --mesh / --profile on the CPU.

torchrun (python -m torch.distributed.run --standalone) starts the ranks
of tpu_ldpc_torch.cli.launch over gloo: two ranks write one CSV (rank 0)
and a Chrome trace each; one rank writes the CSV of the single-process
sweep, row for row.  Both launches start together, once per module."""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = ["--family", "judged", "--device", "cpu", "--ebn0", "3.0", "4.0",
         "--batch", "8", "--max-frames", "16", "--iters", "5"]


def torchrun(nproc, argv, cwd):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "tpu_ldpc_torch.cli.launch",
         "--", *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    procs = {
        2: torchrun(2, SWEEP + ["--csv", "two.csv", "--profile", "prof"],
                    str(tmp)),
        1: torchrun(1, SWEEP + ["--csv", "one.csv"], str(tmp)),
    }
    out = {}
    try:
        for n, p in procs.items():
            out[n] = p.communicate(timeout=240)[0]
            assert p.returncode == 0, out[n][-3000:]
    finally:  # torchrun's workers go with it: a session each
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return tmp, out


def csv_rows(path):
    """The CSV's data rows without the wall time (the last column)."""
    with open(path) as f:
        lines = f.read().strip().splitlines()
    assert lines[0].startswith("# config_hash=")
    return [ln.rsplit(",", 1)[0] for ln in lines[1:]]


def test_two_ranks_one_report(runs):
    tmp, out = runs
    text = out[2]
    assert "[launch] process 0/2: backend gloo" in text
    assert "[launch] process 1/2: backend gloo" in text
    # rank 0 alone prints the table and writes the CSV
    assert text.count("wrote two.csv") == 1
    assert text.count("| Eb/N0 (dB) |") == 1
    assert "ranks=2" in text
    rows = csv_rows(tmp / "two.csv")
    assert [r.split(",")[:2] for r in rows[1:]] == [["3.0", "16"],
                                                    ["4.0", "16"]]


def test_two_ranks_profile_traces(runs):
    """Each rank's Chrome trace carries the port's spans, the sharded
    step's all_reduce among them."""
    tmp, _ = runs
    for rank in (0, 1):
        path = tmp / "prof" / f"trace_rank{rank}.json"
        assert path.stat().st_size > 1000
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        assert {"ldpc.mc.point", "ldpc.mc.call", "ldpc.mc.allreduce",
                "ldpc.mc.read", "ldpc.mc.batch", "ldpc.decode"} <= names


def test_one_rank_equals_the_single_process_sweep(runs):
    """World 1 draws the single-device streams: its CSV equals `python -m
    tpu_ldpc_torch.sim` without a mesh, row for row (wall time aside)."""
    from tpu_ldpc_torch.cli.sim import main

    tmp, out = runs
    assert "[launch] process 0/1" in out[1]
    main(SWEEP + ["--csv", str(tmp / "plain.csv")])
    assert csv_rows(tmp / "one.csv") == csv_rows(tmp / "plain.csv")


def test_mesh_on_the_card_without_one_raises(monkeypatch):
    """--mesh --device cuda needs the card and NCCL; it never runs on the
    CPU in their place."""
    from tpu_ldpc_torch.cli.sim import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--family", "judged", "--mesh", "--device", "cuda"])


def test_nccl_refusals(monkeypatch):
    """More ranks on a host than cards raises before NCCL is asked; a
    build without NCCL raises (no gloo in its place)."""
    import torch.distributed as dist

    from tpu_ldpc_torch.dist.mesh import init_distributed

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        init_distributed(backend="nccl", device="cpu")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")

    def no_init(*a, **kw):
        raise AssertionError("init_process_group reached")

    monkeypatch.setattr(dist, "init_process_group", no_init)
    with pytest.raises(RuntimeError, match="more ranks than cards"):
        init_distributed(backend="nccl", device="cpu")


def test_nccl_refuses_another_card(monkeypatch):
    """Under NCCL rank LOCAL_RANK computes on cuda:LOCAL_RANK: a device
    that names another card raises before NCCL is asked (it never
    computes quietly on the rank's own card instead)."""
    import torch.distributed as dist

    from tpu_ldpc_torch.dist.mesh import init_distributed

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")

    def no_init(*a, **kw):
        raise AssertionError("NCCL or the card was reached")

    monkeypatch.setattr(dist, "init_process_group", no_init)
    monkeypatch.setattr(torch.cuda, "set_device", no_init)
    with pytest.raises(ValueError, match="LOCAL_RANK=0 computes on cuda:0"):
        init_distributed(device="cuda:1")
