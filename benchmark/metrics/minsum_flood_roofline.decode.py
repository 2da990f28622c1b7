"""The flooding min-sum kernel's share of its roofline in decode-only
traffic (``roofline.py``): the least time of the window's decodes over
the device time of the program's flooding kernel."""

from ldpcbench.roofline import flood_roofline


def read(view):
    return flood_roofline(view, "minsum")
