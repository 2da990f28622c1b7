"""Host spans at the port's layer boundaries, recorded as torch.profiler
user annotations.

``span(name)`` is ``torch.profiler.record_function(name)`` while a torch
profiler runs in the process, and one shared no-op context manager
otherwise: the gate is torch's own "is a profiler active" flag, so a run
that profiles nothing pays one flag read a span.  The spans land in the
profiler's trace beside the CUDA runtime calls and the device events, on
their clock; ``cli/sim.py --profile`` and ``cli/bench.py --profile``
export that trace.  Nothing here keeps a timestamp or a buffer.

The spans, outermost first (each nests in the one above it):

- ``ldpc.search``: one ``find_ebn0_at_fer``; ``ldpc.search.probe``: one
  of its probes (one ``run_ber`` point);
- ``ldpc.mc.point``: one Eb/N0 point's host loop of ``run_ber`` /
  ``run_ber_sharded``;
- ``ldpc.mc.call``: one call of the MC step (its batches enqueued; the
  sharded step's ``all_reduce`` as ``ldpc.mc.allreduce``);
  ``ldpc.mc.read``: the host read of a call's counters;
- ``ldpc.mc.batch``: one batch; inside it ``ldpc.mc.seed`` (the batch's
  generator), ``ldpc.mc.draw``, ``ldpc.mc.encode``, ``ldpc.mc.channel``,
  ``ldpc.decode`` (every call of a ``build_decode_fn`` decoder) and
  ``ldpc.mc.count``; on the card ``ldpc.mc.encode`` holds the one kernel
  that encodes and computes the LLRs, and there is no ``ldpc.mc.channel``;
- ``ldpc.decode.gmem``: inside ``ldpc.decode``, the flooding decoder's
  device-memory form (``decode/cuda_bp.py``): its scratch allocation and
  launch;
- ``ldpc.build``: a build (nvcc, or a cache-missed builder of a step,
  decoder, encoder or kernel plan), wherever it happens.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager that records the span `name` while a torch
    profiler runs, and the one shared no-op otherwise."""
    return record_function(name) if _profiling() else _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap
