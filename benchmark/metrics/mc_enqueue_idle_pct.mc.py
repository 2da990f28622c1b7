"""Share of the traced window in which the device idled while the host
was inside the MC step's call (the span ``ldpc.mc.call``: enqueueing its
batches), by overlap with the idle gaps (``ldpcbench/spans.py``)."""

from ldpcbench.spans import idle_pct


def read(view):
    return idle_pct(view.trace, ("ldpc.mc.call",))
