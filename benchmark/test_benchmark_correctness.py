"""Tests that the benchmark's correctness check can fail: the
lower-precision control reads above every limit, and a run with the
timed path broken underneath comes out not correct.

    python -m pytest benchmark/test_benchmark_correctness.py -q

The CPU tests run every cell of BENCHMARK.json at its CPU cut
(``traffic/cpu/<traffic>.json``) with the program's plain decoders, a
cell of several cards on two gloo ranks, with the fault planted in rank
0 (this process); ``test_control_at_the_cells_size`` is marked ``cuda``
and runs the cells as committed on the cards they ask for.
"""

import contextlib

import pytest
import torch

from conftest import CPU_RANKS, cells, chips, cpu_run, small_copy

import control
from ldpcbench import harness


def _unchanged(fn):
    """The decoder returns its input state: the channel's hard decision,
    no iteration run."""
    def run(llr):
        F = llr.shape[0]
        return ((llr < 0).to(torch.uint8),
                torch.zeros(F, dtype=torch.bool, device=llr.device),
                torch.zeros(F, dtype=torch.int32, device=llr.device))
    return run


def _half_batch(fn):
    """Half of the batch decoded; the other half's answers copied from
    it."""
    def run(llr):
        F = llr.shape[0]
        outs = fn(llr[:F // 2 + F % 2].contiguous())
        return tuple(torch.cat([x, x[:F // 2]]) for x in outs)
    return run


def _altered(fn):
    """One bit of the first frame flipped where the decoder produces it."""
    def run(llr):
        bits, ok, iu = fn(llr)
        bits = bits.clone()
        bits[0, 0] ^= 1
        return bits, ok, iu
    return run


def _own_counters(all_reduce):
    """The exchange between cards left out: every rank still takes part
    in the collective, and keeps its own counters."""
    def run(self, x):
        own = x.clone()
        all_reduce(self, x)
        return own
    return run


DECODER_FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
                  "altered": _altered}
FAULTS = dict(DECODER_FAULTS, exchange=_own_counters)


def faults(cell):
    """The faults a cell can have: the exchange only across cards."""
    return sorted(FAULTS if chips(cell) > 1 else DECODER_FAULTS)


@contextlib.contextmanager
def planted(fault):
    """Every decoder the program builds (throughput decoder, MC steps,
    search probes) wrapped by FAULTS[fault], or, for "exchange", the
    mesh's all_reduce."""
    import tpu_ldpc_torch.decode.api as api
    import tpu_ldpc_torch.dist.mesh as mesh
    import tpu_ldpc_torch.sim.mc as mc

    if fault == "exchange":
        owners, name = (mesh.Mesh,), "all_reduce"
        real = mesh.Mesh.all_reduce
        fake = FAULTS[fault](real)
    else:
        owners, name = (api, mc), "build_decode_fn"
        real = api.build_decode_fn

        def fake(*args, **kw):
            return FAULTS[fault](real(*args, **kw))
    caches = (mc._build_mc_step, mesh.build_sharded_mc_step)
    for c in caches:
        c.cache_clear()
    for o in owners:
        setattr(o, name, fake)
    try:
        yield
    finally:
        for o in owners:
            setattr(o, name, real)
        for c in caches:
            c.cache_clear()


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in cells() for f in faults(c)])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    root, bench_dir = small_copy(str(tmp_path))
    with planted(fault):
        result, checks, _ = cpu_run(root, bench_dir, cell, 2**31 + 9, 0.3)
    assert not result["correct"], checks
    assert any(v > lim for _, v, lim in checks) or result["failed"]


@pytest.mark.parametrize("cell", cells())
def test_control_reads_above_the_limits(tmp_path, cell):
    root, bench_dir = small_copy(str(tmp_path))
    out = control.readings(root, bench_dir, cell, 0.3, [2**31 + 1],
                           [2**31 + 2, 2**31 + 3, 2**31 + 4], "cpu",
                           world=min(chips(cell), CPU_RANKS))
    assert all(v == 0 for vs in out["program"].values() for v in vs)
    # the control has to fail one of the cell's numbers on every seed
    per_seed = zip(*out["control"].values())
    assert all(any(v > 0 for v in seed) for seed in per_seed), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < chips(cell):
        pytest.skip(f"needs {chips(cell)} CUDA cards")
    out = control.readings(harness.ROOT, harness.BENCH_DIR, cell, 2.0,
                           [2**31 + 21], [2**31 + 22, 2**31 + 23, 2**31 + 24],
                           "cuda")
    assert all(v == 0 for vs in out["program"].values() for v in vs)
    per_seed = zip(*out["control"].values())
    assert all(any(v > 0 for v in seed) for seed in per_seed), out
