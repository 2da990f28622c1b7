"""CPU tests of ``ldpcbench/spans.py`` and the readers of the program's
spans: on synthetic traces (host events and idle gaps written by hand, in
ns) every nanosecond of idle goes to the innermost span that covers it,
the shares and "outside the program" add up to the device's idle share,
runtime calls count per span, and every reader returns None without
device activity or without the program's spans; on a real CPU profile of
the MC step the chains follow the program's nesting.

    python -m pytest benchmark/test_benchmark_spans.py -q
"""

import os

import pytest
import torch

from conftest import HERE

from ldpcbench import harness, spans
from ldpcbench.trace import WINDOW, Trace, Tracer

READERS = ("mc_enqueue_idle_pct.mc", "launches_per_batch.mc",
           "search_host_idle_pct.search", "mc_enqueue_idle_pct.search",
           "mc_read_idle_pct.search", "host_syncs_per_call.search")

# one search of one probe of one call of two batches, then the read;
# (start, end, name, annotation)
HOST = [
    (0, 1000, WINDOW, True),
    (2, 995, "bench.search", True),
    (5, 990, "ldpc.search", True),
    (10, 900, "ldpc.search.probe", True),
    (11, 19, "ldpc.build", True),
    (20, 890, "ldpc.mc.point", True),
    (25, 400, "ldpc.mc.call", True),
    (30, 200, "ldpc.mc.batch", True),
    (100, 150, "ldpc.decode", True),
    (200, 390, "ldpc.mc.batch", True),
    (600, 700, "ldpc.mc.read", True),
    (40, 45, "cudaLaunchKernel", False),
    (120, 125, "cudaLaunchKernel", False),
    (250, 255, "cudaLaunchKernel", False),
    (260, 265, "cudaLaunchKernelExC_v11060", False),
    (395, 398, "cudaLaunchKernel", False),         # in the call, no batch
    (300, 310, "cudaMemcpy", False),               # in a batch
    (610, 615, "cudaMemcpyAsync", False),          # not blocking by name
    (620, 640, "cudaStreamSynchronize", False),    # in the read
    (950, 960, "cudaEventSynchronize", False),     # in the search only
    (997, 999, "cudaDeviceSynchronize", False),    # outside the program
]
GAPS = [(0, 30), (140, 210), (650, 800), (880, 1000)]  # 370 ns of 1000


def trace(host=HOST, gaps=GAPS, busy_ns=None):
    tr = object.__new__(Trace)
    tr._host = sorted(host)
    tr.gaps = list(gaps)
    tr.window_s = 1000e-9
    tr.busy_s = (1000 - sum(b - a for a, b in gaps) if busy_ns is None
                 else busy_ns) * 1e-9
    return tr


def read(name, tr):
    reader = harness.load_module(
        os.path.join(HERE, "metrics", f"{name}.py"),
        "reader_" + name.replace(".", "_"))
    return reader.read(harness.View(tr, {}, {}, {}))


def test_a_gap_is_split_between_the_spans_it_straddles():
    shares = spans.of(trace()).idle_by_span()
    assert shares == pytest.approx({
        spans.OUTSIDE: 1.5,       # [0, 5) and [990, 1000)
        "ldpc.search": 9.5,       # [5, 10) and [900, 990)
        "ldpc.search.probe": 1.2,
        "ldpc.build": 0.8,
        "ldpc.mc.point": 11.5,    # [20, 25), [700, 800), [880, 890)
        "ldpc.mc.call": 0.5,
        "ldpc.mc.batch": 6.0,     # [150, 200) and [200, 210): two batches
        "ldpc.decode": 1.0,       # [140, 150)
        "ldpc.mc.read": 5.0,
    })


def test_the_shares_add_up_to_the_device_idle_share():
    tr = trace()
    total = read("device_idle_pct.search", tr)
    assert total == pytest.approx(37.0)
    assert sum(spans.of(tr).idle_by_span().values()) == pytest.approx(total)
    parts = {name: read(name, tr) for name in (
        "search_host_idle_pct.search", "mc_enqueue_idle_pct.search",
        "mc_read_idle_pct.search")}
    assert parts == pytest.approx({"search_host_idle_pct.search": 23.0,
                                   "mc_enqueue_idle_pct.search": 7.5,
                                   "mc_read_idle_pct.search": 5.0})
    assert sum(parts.values()) + 1.5 == pytest.approx(total)
    assert read("mc_enqueue_idle_pct.mc", tr) == pytest.approx(7.5)


def test_launches_and_syncs_count_per_span():
    tr = trace()
    # 4 launches in the two batches (one with a version suffix); the one
    # between the batches is not a batch's
    assert read("launches_per_batch.mc", tr) == 2.0
    # cudaMemcpy in the call and the synchronize of the read; not the
    # event synchronize of the bisection nor the one outside the program
    assert read("host_syncs_per_call.search", tr) == 2.0
    two_calls = HOST + [(420, 580, "ldpc.mc.call", True)]
    assert read("host_syncs_per_call.search", trace(two_calls)) == 1.0


def test_nested_chains_and_cut_spans():
    segs = spans._segments([(0, 10, "a"), (2, 4, "b"), (3, 12, "c"),
                            (20, 30, "d")])
    # c would outlast b, its holder: it is cut at b's end
    assert segs == [(0, 2, ("a",)), (2, 3, ("a", "b")),
                    (3, 4, ("a", "b", "c")), (4, 10, ("a",)),
                    (20, 30, ("d",))]
    sp = spans.of(trace())
    assert sp.chain_at(120) == ("ldpc.search", "ldpc.search.probe",
                                "ldpc.mc.point", "ldpc.mc.call",
                                "ldpc.mc.batch", "ldpc.decode")
    assert sp.chain_at(3) == () and sp.chain_at(995) == ()


@pytest.mark.parametrize("name", READERS)
def test_every_reader_returns_none_without_device_or_spans(name):
    assert read(name, None) is None
    assert read(name, trace(busy_ns=0)) is None  # no device activity
    # a program that records no span of its own (the parent commit's)
    bare = [h for h in HOST if not h[2].startswith("ldpc.")]
    assert read(name, trace(bare)) is None
    assert read(name, trace()) > 0


def test_a_cpu_profile_of_the_mc_step_nests_as_the_program_does():
    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    step = build_mc_step(LdpcCode.from_family("wifi", "1/2", 27),
                         DecodeCfg(iters=4), 8, 3, device="cpu")
    step(1, 0, 1.0, 0).tolist()
    tracer = Tracer(True)
    with tracer:
        with tracer.span(WINDOW):
            for i in range(2):
                with tracer.span("bench.mc_call"):
                    acc = step(1, 0, 1.0, 3 * i)
                with tracer.span("bench.mc_read"):
                    acc.tolist()
    tr = tracer.trace()
    assert tr.busy_s == 0 and spans.of(tr) is None  # no device here
    sp = spans.Spans(tr)
    assert sp.counts["ldpc.mc.call"] == 2
    assert sp.counts["ldpc.mc.batch"] == 6
    for stage in ("ldpc.mc.seed", "ldpc.mc.draw", "ldpc.mc.encode",
                  "ldpc.mc.channel", "ldpc.decode", "ldpc.mc.count"):
        assert sp.counts[stage] == 6
        chains = {c for _, _, c in sp.segments if c[-1] == stage}
        assert chains == {("ldpc.mc.call", "ldpc.mc.batch", stage)}
    # the whole window is one idle gap: the calls take their share of it
    assert sum(sp.idle.values()) == pytest.approx(tr.window_s * 1e9)
    assert 0 < sp.idle_pct(("ldpc.mc.call",)) < 100
    assert torch.is_tensor(acc)


def test_the_all_reduce_reader_reads_nccl_kernels_alone():
    tr = object.__new__(Trace)
    tr.window_s = 2.0
    tr.by_name = {"void bp_flood_kernel<MinSum>(...)": 1.5,
                  "ncclDevKernel_AllReduce_Sum_u64_RING_LL(...)": 0.02,
                  "Memcpy DtoH (Device -> Pageable)": 0.01}
    assert read("mc_allreduce_device_pct.x4", tr) == pytest.approx(1.0)
    del tr.by_name["ncclDevKernel_AllReduce_Sum_u64_RING_LL(...)"]
    assert read("mc_allreduce_device_pct.x4", tr) is None
    assert read("mc_allreduce_device_pct.x4", None) is None
