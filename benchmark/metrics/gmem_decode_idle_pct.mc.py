"""Share of the traced window in which the device idled while the host
was inside the device-memory flooding decode's span
(``ldpc.decode.gmem``: allocating the codewords' state and launching the
kernel), by overlap with the idle gaps (``ldpcbench/spans.py``).  None
for a program that records no such span."""

from ldpcbench.spans import idle_pct


def read(view):
    return idle_pct(view.trace, ("ldpc.decode.gmem",))
