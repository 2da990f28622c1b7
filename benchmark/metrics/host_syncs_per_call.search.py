"""Blocking CUDA runtime calls (stream, device and event synchronizes,
synchronous copies) the host made inside the search's MC step calls and
counter reads (``ldpc.mc.call``, ``ldpc.mc.read``), per call."""

from ldpcbench.spans import SYNCS, per_span


def read(view):
    return per_span(view.trace,
                    lambda sp: sp.calls_under(
                        SYNCS, ("ldpc.mc.call", "ldpc.mc.read")),
                    "ldpc.mc.call")
