"""Kernel launches (the CUDA runtime's and driver's launch calls) the
host issued inside the MC step's batches (spans ``ldpc.mc.batch``), per
batch."""

from ldpcbench.spans import LAUNCHES, per_span


def read(view):
    return per_span(view.trace,
                    lambda sp: sp.calls_under(LAUNCHES, ("ldpc.mc.batch",)),
                    "ldpc.mc.batch")
