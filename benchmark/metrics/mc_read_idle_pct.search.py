"""Share of the traced window in which the device idled while the host
was inside a search's read of a call's counters (``ldpc.mc.read`` under
``ldpc.search``: the host sync of a call)."""

from ldpcbench.spans import idle_pct


def read(view):
    return idle_pct(view.trace, ("ldpc.search", "ldpc.mc.read"))
