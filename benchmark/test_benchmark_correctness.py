"""Tests that the benchmark's correctness check can fail: the
lower-precision control reads above every limit, and a run with the
timed path broken underneath comes out not correct.

    python -m pytest benchmark/test_benchmark_correctness.py -q

The CPU tests run the cells at a cut size (``conftest.SMALL``) with the
program's plain decoders; ``test_control_at_the_cells_size`` is marked
``cuda`` and runs the cells as committed on a card.
"""

import contextlib

import pytest
import torch

from conftest import CELLS, small_copy

import control
from ldpcbench import harness

CPU = torch.device("cpu")


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


# one chip a cell: the exchange between chips has no fault to plant
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}


@contextlib.contextmanager
def planted(fault):
    """Every decoder the program builds (throughput decoder, MC step,
    search probes) wrapped by FAULTS[fault]."""
    import tpu_ldpc_torch.decode.api as api
    import tpu_ldpc_torch.sim.mc as mc

    real = api.build_decode_fn

    def build(*args, **kw):
        return FAULTS[fault](real(*args, **kw))

    mc._build_mc_step.cache_clear()
    api.build_decode_fn = mc.build_decode_fn = build
    try:
        yield
    finally:
        api.build_decode_fn = mc.build_decode_fn = real
        mc._build_mc_step.cache_clear()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    root, bench_dir = small_copy(str(tmp_path))
    with planted(fault):
        result, checks, _ = harness.run_cell(root, bench_dir, cell, 2**31 + 9,
                                             0.3, False, CPU, 0.0)
    assert not result["correct"], checks
    assert any(v > lim for _, v, lim in checks) or result["failed"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_limits(tmp_path, cell):
    root, bench_dir = small_copy(str(tmp_path))
    out = control.readings(root, bench_dir, cell, 0.3, [2**31 + 1],
                           [2**31 + 2, 2**31 + 3, 2**31 + 4], CPU)
    assert all(v == 0 for vs in out["program"].values() for v in vs)
    # the control has to fail one of the cell's numbers on every seed
    per_seed = zip(*out["control"].values())
    assert all(any(v > 0 for v in seed) for seed in per_seed), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = control.readings(harness.ROOT, harness.BENCH_DIR, cell, 2.0,
                           [2**31 + 21], [2**31 + 22, 2**31 + 23, 2**31 + 24],
                           torch.device("cuda", 0))
    assert all(v == 0 for vs in out["program"].values() for v in vs)
    per_seed = zip(*out["control"].values())
    assert all(any(v > 0 for v in seed) for seed in per_seed), out
