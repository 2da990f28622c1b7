"""Share of rank 0's traced window in which no operation ran on its
card: 1 - (union of device-busy intervals / window).  Only rank 0 is
traced."""


def read(view):
    tr = view.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
