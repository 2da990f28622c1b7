"""Share of the traced window in which no operation ran on the device:
1 - (union of device-busy intervals / window)."""


def read(view):
    tr = view.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
