"""Share of the traced window in which the device idled while the host
was inside a search (span ``ldpc.search``) but outside every MC step call
and counter read (``ldpc.mc.call``, ``ldpc.mc.read``): the bisection, each
probe's set-up and any build."""

from ldpcbench.spans import idle_pct


def read(view):
    return idle_pct(view.trace, ("ldpc.search",),
                    ("ldpc.mc.call", "ldpc.mc.read"))
