"""The device's idle time and the host's runtime calls, put down to the
program's own spans (``tpu_ldpc_torch/spans.py``: host annotations named
``ldpc.*``, on the profiler's clock).

``Spans(trace)`` reads a ``trace.Trace``: its idle gaps and its host
events.  The program's spans nest (one thread records them), so the
window splits into stretches, each covered by one chain of open spans
(outermost first), and stretches that no span covers: there the host was
outside the program (the benchmark's own code, or nothing).  Every
nanosecond of every idle gap goes to the chain that covers it, by
overlap: a gap that straddles two spans is split between them.  (The
trace's own ``idle_gaps`` names a whole gap by what covered its start.)

A trace without the program's spans (a program that records none)
yields no chain: every reader that asks for a span then finds none and
returns None.
"""

from __future__ import annotations

import bisect
import re
import weakref

from ldpcbench.trace import WINDOW

PREFIX = "ldpc."
OUTSIDE = "outside the program"
# CUDA runtime and driver calls by name (a trace may add a version
# suffix, "_v11060")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
_VERSION = re.compile(r"_v\d+$")
_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def of(trace) -> "Spans | None":
    """The Spans of `trace` (read once a trace), or None when the trace
    holds no device activity."""
    if trace is None or trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    if trace not in _cache:
        _cache[trace] = Spans(trace)
    return _cache[trace]


def _segments(spans) -> list:
    """[(t0, t1, chain)]: the stretches in which a span is open, in time
    order, each with the names of the spans open there, outermost first.
    A span that would outlast the one holding it is cut at its end."""
    out, stack, pos = [], [], 0  # stack: (end, chain), innermost last

    def close(until):
        nonlocal pos
        while stack and stack[-1][0] <= until:
            end, chain = stack.pop()
            if end > pos:
                out.append((pos, end, chain))
                pos = end

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close(start)
        if stack:
            if start > pos:
                out.append((pos, start, stack[-1][1]))
            end = min(end, stack[-1][0])
            chain = stack[-1][1] + (name,)
        else:
            chain = (name,)
        stack.append((end, chain))
        pos = start
    close(float("inf"))
    return out


class Spans:
    def __init__(self, trace):
        host = trace._host
        window = [h for h in host if h[3] and h[2] == WINDOW]
        self.w0, self.w1 = window[-1][0], window[-1][1]
        self.window_ns = self.w1 - self.w0
        spans = [(s, e, n) for s, e, n, a in host
                 if a and n.startswith(PREFIX) and self.w0 <= s <= self.w1]
        self.counts: dict[str, int] = {}
        for _, _, n in spans:
            self.counts[n] = self.counts.get(n, 0) + 1
        self.segments = _segments(spans)
        self._starts = [s for s, _, _ in self.segments]
        self.idle: dict[tuple, int] = {}  # chain -> idle ns; () outside
        j = 0
        for g0, g1 in trace.gaps:
            while j < len(self.segments) and self.segments[j][1] <= g0:
                j += 1
            left, k = g1 - g0, j
            while k < len(self.segments) and self.segments[k][0] < g1:
                s, e, chain = self.segments[k]
                overlap = min(g1, e) - max(g0, s)
                if overlap > 0:
                    self.idle[chain] = self.idle.get(chain, 0) + overlap
                    left -= overlap
                k += 1
            if left > 0:
                self.idle[()] = self.idle.get((), 0) + left
        # runtime calls by bare name -> start times (host events that are
        # not annotations)
        self._calls: dict[str, list] = {}
        for s, _, n, a in host:
            if not a and self.w0 <= s <= self.w1:
                self._calls.setdefault(_VERSION.sub("", n), []).append(s)

    def chain_at(self, t) -> tuple:
        """The chain of spans open at time t (() where none is)."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return ()

    def idle_pct(self, under, outside=()) -> float:
        """% of the window in which the device idled while every span
        named in `under` was open and none named in `outside` was."""
        ns = sum(v for chain, v in self.idle.items()
                 if all(u in chain for u in under)
                 and not any(o in chain for o in outside))
        return 100.0 * ns / self.window_ns

    def idle_by_span(self) -> dict:
        """{innermost span name or OUTSIDE: % of the window idle there}."""
        out: dict[str, float] = {}
        for chain, v in self.idle.items():
            name = chain[-1] if chain else OUTSIDE
            out[name] = out.get(name, 0.0) + 100.0 * v / self.window_ns
        return out

    def calls_under(self, names, under) -> int:
        """Runtime calls named in `names` that start while a span named in
        `under` is open."""
        return sum(1 for n in names for t in self._calls.get(n, ())
                   if any(u in self.chain_at(t) for u in under))


def per_span(trace, count, span):
    """count(spans) / the number of `span` spans, or None when the trace
    has no device activity or no such span."""
    sp = of(trace)
    if sp is None or not sp.counts.get(span):
        return None
    return count(sp) / sp.counts[span]


def idle_pct(trace, under, outside=()):
    """Spans.idle_pct, or None when the trace has no device activity or
    no span named in `under`."""
    sp = of(trace)
    if sp is None or not all(sp.counts.get(u) for u in under):
        return None
    return sp.idle_pct(under, outside)
