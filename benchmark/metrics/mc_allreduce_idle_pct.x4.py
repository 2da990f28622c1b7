"""Share of rank 0's traced window in which its card idled while the
host was inside the sharded step's all_reduce of the counters (the span
``ldpc.mc.allreduce``), by overlap with the idle gaps
(``ldpcbench/spans.py``)."""

from ldpcbench.spans import idle_pct


def read(view):
    return idle_pct(view.trace, ("ldpc.mc.allreduce",))
