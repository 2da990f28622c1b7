"""The port's spans (tpu_ldpc_torch/spans.py) under torch.profiler on the
CPU: every layer boundary of run_ber, find_ebn0_at_fer and decode()
records its span, nested as the module docstring lists, as often as the
work done; a build records ``ldpc.build`` once; with no profiler active
``span`` is one shared no-op, and the counters do not change with the
profiler on."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.channel.adapt import RateAdapt
from tpu_ldpc_torch.decode import decode
from tpu_ldpc_torch.sim import mc
from tpu_ldpc_torch.sim.mc import DecodeCfg, run_ber
from tpu_ldpc_torch.sim.search import find_ebn0_at_fer
from tpu_ldpc_torch.spans import span, spanned

CFG = DecodeCfg(iters=6)
BATCH = 16
STAGES = ("ldpc.mc.seed", "ldpc.mc.draw", "ldpc.mc.encode",
          "ldpc.mc.channel", "ldpc.decode", "ldpc.mc.count")
# span -> the innermost ldpc.* span that holds it (None: none does)
PARENT = {"ldpc.search": None,
          "ldpc.search.probe": "ldpc.search",
          "ldpc.mc.point": "ldpc.search.probe",
          "ldpc.mc.call": "ldpc.mc.point",
          "ldpc.mc.read": "ldpc.mc.point",
          "ldpc.mc.batch": "ldpc.mc.call",
          **dict.fromkeys(STAGES, "ldpc.mc.batch")}


def code():
    return LdpcCode.from_family("wifi", "1/2", 27)  # n = 648


def recorded(fn):
    """(fn(), [(name, parent name or None), ...]) of the ldpc.* spans fn
    records under torch.profiler, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation() and e.name().startswith("ldpc."))
    spans, stack = [], []
    for start, neg_end, name in evs:
        while stack and stack[-1][0] <= start:
            stack.pop()
        spans.append((name, stack[-1][1] if stack else None))
        stack.append((-neg_end, name))
    return out, spans


def names(spans):
    return [name for name, _ in spans]


def sweep(spc, max_frames=None, ebn0=0.5):
    """A run_ber point that stops on its frame cap after `calls` calls."""
    return run_ber(code(), [ebn0], CFG, batch=BATCH, target_frame_errors=10**6,
                   max_frames=max_frames or 2 * spc * BATCH, seed=5,
                   steps_per_call=spc, device="cpu")


def search():
    return find_ebn0_at_fer(code(), 0.5, CFG, lo=0.0, hi=4.0, tol_db=1.0,
                            target_frame_errors=4, max_frames=32,
                            batch=BATCH, seed=2, device="cpu")


@pytest.mark.parametrize("what", ["run_ber", "search"])
def test_every_span_nested_as_listed(what):
    mc._build_mc_step.cache_clear()  # the first run builds its step
    _, spans = recorded(lambda: sweep(2) if what == "run_ber" else search())
    want = set(PARENT) - ({"ldpc.search", "ldpc.search.probe"}
                          if what == "run_ber" else set())
    got = {name for name, _ in spans}
    assert got == want | {"ldpc.build"}
    for name, parent in spans:
        if name == "ldpc.build":
            # built before the point's loop, inside nothing of the MC
            assert parent in (None, "ldpc.search.probe", "ldpc.build")
        elif name == "ldpc.mc.point" and what == "run_ber":
            assert parent is None
        else:
            assert parent == PARENT[name], (name, parent)


@pytest.mark.parametrize("spc", [1, 2, 3])
def test_span_counts_follow_the_work(spc):
    sweep(spc)  # built beforehand
    res, spans = recorded(lambda: sweep(spc, max_frames=3 * spc * BATCH))
    n = names(spans)
    calls = n.count("ldpc.mc.call")
    assert calls == res[0].frames // (spc * BATCH) == 3
    assert n.count("ldpc.mc.batch") == spc * calls
    assert n.count("ldpc.mc.read") == calls
    assert n.count("ldpc.mc.point") == 1
    for stage in STAGES:
        assert n.count(stage) == spc * calls, stage


def test_search_counts_a_probe_a_point():
    res, spans = recorded(search)
    n = names(spans)
    assert n.count("ldpc.search") == 1
    assert n.count("ldpc.search.probe") == len(res.probes) >= 3
    assert n.count("ldpc.mc.point") == len(res.probes)
    frames = sum(p.frames for p in res.probes)
    assert n.count("ldpc.mc.batch") == frames // BATCH  # one batch a call
    assert n.count("ldpc.mc.read") == n.count("ldpc.mc.call")


@pytest.mark.parametrize("what", ["run_ber", "search"])
def test_a_second_identical_run_builds_nothing(what):
    run = (lambda: sweep(2)) if what == "run_ber" else search
    mc._build_mc_step.cache_clear()
    first, spans = recorded(run)
    assert "ldpc.build" in names(spans)
    second, spans = recorded(run)
    assert "ldpc.build" not in names(spans)
    assert "ldpc.mc.call" in names(spans)


@pytest.mark.parametrize("kw", [
    {}, {"schedule": "layered"}, {"algo": "sumproduct-fast"},
    {"algo": "bitflip", "iters": 10}])
def test_decode_records_its_span(kw):
    c = code()
    llr = torch.full((3, c.n), 4.0)
    (bits, ok, _), spans = recorded(
        lambda: decode(c, llr, device="cpu", **{"iters": 4, **kw}))
    assert ok.all() and not bits.any()
    assert names(spans).count("ldpc.decode") == 1


def test_span_is_one_shared_noop_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("ldpc.x"), span("ldpc.y")
    assert a is b
    with a:
        pass

    @spanned("ldpc.z")
    def f(x, *, y):
        """doc"""
        return x + y

    assert f(1, y=2) == 3 and f.__name__ == "f" and f.__doc__ == "doc"
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("ldpc.x") is not a


@pytest.mark.parametrize("punctured", [False, True])
def test_counters_equal_with_the_profiler_on_and_off(punctured):
    c = code()
    adapt = (RateAdapt.from_blocks(c, puncture_blocks=(0,)) if punctured
             else None)

    def run():
        return run_ber(c, [1.0, 2.0], CFG, batch=BATCH, max_frames=64,
                       target_frame_errors=10**6, seed=2**31 + 9,
                       steps_per_call=2, adapt=adapt, device="cpu")

    off = run()
    on, spans = recorded(run)
    assert names(spans).count("ldpc.mc.point") == 2
    for a, b in zip(off, on):
        assert [getattr(a, f) for f in mc.COUNTER_FIELDS] == [
            getattr(b, f) for f in mc.COUNTER_FIELDS]
