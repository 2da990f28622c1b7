"""The port's FER search (sim/search.py) vs the JAX package's.

Both bisections are driven by the same stubbed, monotone FER curve in
place of run_ber: they must probe the same Eb/N0 sequence with the same
frame caps and return the same result, in the converged case and in
both out-of-range cases.
"""

import dataclasses
import math

import pytest

import tpu_ldpc.sim.search as jax_search
import tpu_ldpc_torch.sim.search as port_search
from tpu_ldpc_torch.sim.mc import DecodeCfg


@dataclasses.dataclass
class Probe:
    ebn0_db: float
    fer: float
    frames: int


def waterfall(ebn0_db: float) -> float:
    """A monotone FER curve: 0.5 at 1.0 dB, falling a decade per 0.4 dB."""
    return min(1.0, 0.5 * 10 ** (-(ebn0_db - 1.0) / 0.4))


def stub(calls):
    def run_ber(code, grid, cfg=None, batch=256, target_frame_errors=100,
                max_frames=1_000_000, seed=0, **kw):
        (ebn0,) = grid
        calls.append((ebn0, max_frames, batch, target_frame_errors, seed,
                      cfg, tuple(sorted(kw))))
        return [Probe(ebn0, waterfall(ebn0), max_frames)]
    return run_ber


def both(monkeypatch, **kw):
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_search, "run_ber", stub(jax_calls))
    monkeypatch.setattr(port_search, "run_ber", stub(port_calls))
    want = jax_search.find_ebn0_at_fer(None, **kw)
    got = port_search.find_ebn0_at_fer(None, **kw, device="cpu")
    return want, got, jax_calls, port_calls


@pytest.mark.parametrize("target,lo,hi,converged", [
    (1e-2, 0.0, 6.0, True),
    (1e-3, 0.5, 2.5, True),
    (0.9, 1.5, 3.0, False),   # already below target at the low end
    (1e-6, 0.0, 2.0, False),  # the range never reaches the target
])
def test_search_matches_jax(monkeypatch, target, lo, hi, converged):
    cfg = DecodeCfg(algo="sumproduct-fast")
    want, got, jax_calls, port_calls = both(
        monkeypatch, target_fer=target, cfg=cfg, lo=lo, hi=hi, tol_db=0.05,
        target_frame_errors=40, batch=64, seed=3)
    assert [c[:5] for c in port_calls] == [c[:5] for c in jax_calls]
    assert all(c[5] is cfg for c in port_calls)
    # run_ber gets adapt and mesh as in the JAX package, and the device
    assert {c[6] for c in port_calls} == {("adapt", "device", "mesh")}
    assert {c[6] for c in jax_calls} == {("adapt", "mesh")}
    assert port_calls[0][1] == int(4 * 40 / target)  # default max_frames
    assert got.converged == want.converged == converged
    assert got.bracket == want.bracket
    assert got.ebn0_db == want.ebn0_db and got.target_fer == target
    assert [p.ebn0_db for p in got.probes] == [c[0] for c in port_calls]
    if converged:
        b_lo, b_hi = got.bracket
        assert b_hi - b_lo <= 0.05
        crossing = 1.0 + 0.4 * math.log10(0.5 / target)
        assert b_lo <= crossing <= b_hi
    else:
        assert got.bracket == ((lo, lo) if target > waterfall(lo)
                               else (hi, hi))


def test_search_rejects_bad_targets(monkeypatch):
    monkeypatch.setattr(port_search, "run_ber", stub([]))
    for target in (0.0, 1.0, -0.1, 2.0):
        with pytest.raises(ValueError, match="target_fer"):
            port_search.find_ebn0_at_fer(None, target, device="cpu")
    with pytest.raises(TypeError):
        port_search.find_ebn0_at_fer(None, 1e-2)  # device is required


def test_search_forwards_adapt(monkeypatch):
    """Every probe runs with the search's rate adaptation, as in JAX."""
    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.channel.adapt import RateAdapt

    adapt = RateAdapt.from_blocks(LdpcCode.judged(), puncture_blocks=(15,))
    seen = []

    def run_ber(code, grid, adapt=None, **kw):
        seen.append(adapt)
        return [Probe(grid[0], waterfall(grid[0]), kw["max_frames"])]

    monkeypatch.setattr(port_search, "run_ber", run_ber)
    sr = port_search.find_ebn0_at_fer(None, 1e-2, adapt=adapt, device="cpu")
    assert sr.converged and len(seen) == len(sr.probes) > 2
    assert all(a is adapt for a in seen)
