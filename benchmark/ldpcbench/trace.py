"""Spans from the benchmark's own files, and the reduction of a
torch.profiler trace to device time by kernel name, device busy time and
idle gaps.

``Tracer(enabled)`` runs torch.profiler (host and CUDA activity) while it
is entered; ``tracer.span(name)`` records a host span there (a no-op when
tracing is off).  The run's measured window is the span ``WINDOW``.

``Trace`` reads the profiler's raw events once:

* the device events (kernels, copies, sets) inside the window;
* ``busy_s``: the length of the union of their intervals;
* ``window_s``: the window span's length;
* ``by_name``: device seconds summed by operation name;
* idle gaps: the stretches of the window in which no device operation
  ran, each named by what the host was doing at its start (the innermost
  host event covering it, under the outermost benchmark span).
"""

from __future__ import annotations

import contextlib

WINDOW = "bench.window"
TOP = 10  # entries of each breakdown list


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self.prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def trace(self) -> "Trace | None":
        return None if self.prof is None else Trace(self.prof)


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        host, device = [], []
        window = None
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns()
            end = start + ev.duration_ns()
            name = ev.name()
            annotation = ev.is_user_annotation()
            if ev.device_type() == DeviceType.CPU:
                if name == WINDOW:
                    window = (start, end)
                host.append((start, end, name, annotation))
            elif not annotation and not name.startswith("bench."):
                device.append((start, end, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device
                        if e > w0 and s < w1)
        self.by_name: dict[str, float] = {}
        for s, e, n in device:
            self.by_name[n] = self.by_name.get(n, 0.0) + (e - s) * 1e-9
        busy, gaps, cur = 0, [], w0
        for s, e, _ in device:
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if w1 > cur:
            gaps.append((cur, w1))
        self.busy_s = busy * 1e-9
        self.gaps = gaps
        self._host = sorted(h for h in host if w0 <= h[1] and h[0] <= w1)

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(t for n, t in self.by_name.items() if match(n))

    def device_ops(self) -> list:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, t] for n, t in top]

    def idle_gaps(self) -> list:
        """The host activities under which the device sat idle longest:
        [[name, seconds], ...], every gap's seconds summed by the name of
        what the host was doing at its start."""
        named: dict[str, float] = {}
        # one sweep in time: `open_` holds the host events that cover the
        # current instant, outermost first (host events nest)
        open_, i = [], 0
        for g0, g1 in self.gaps:  # in time order
            while i < len(self._host) and self._host[i][0] <= g0:
                while open_ and open_[-1][1] < self._host[i][0]:
                    open_.pop()
                open_.append(self._host[i])
                i += 1
            while open_ and open_[-1][1] < g0:
                open_.pop()
            cover = [h for h in open_ if h[1] >= g0]
            spans = [h[2] for h in cover if h[3] and h[2] != WINDOW]
            if not cover:
                name = "host: outside any event"
            elif not spans or spans[0] == cover[-1][2]:
                name = cover[-1][2]
            else:
                name = f"{spans[0]} > {cover[-1][2]}"
            named[name] = named.get(name, 0.0) + (g1 - g0) * 1e-9
        top = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, t] for n, t in top]
