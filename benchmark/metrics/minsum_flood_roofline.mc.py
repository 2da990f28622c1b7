"""The flooding min-sum kernel's share of its roofline inside the MC step
(``roofline.py``), its operations counted from the iterations the frames
ran (the counters' iter_sum)."""

from ldpcbench.roofline import flood_roofline


def read(view):
    return flood_roofline(view, "minsum")
