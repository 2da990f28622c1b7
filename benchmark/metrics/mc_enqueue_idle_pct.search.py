"""Share of the traced window in which the device idled while the host
was inside a search's MC step call (``ldpc.mc.call`` under
``ldpc.search``: enqueueing its batches)."""

from ldpcbench.spans import idle_pct


def read(view):
    return idle_pct(view.trace, ("ldpc.search", "ldpc.mc.call"))
