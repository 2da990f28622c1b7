"""Iterations a frame took to converge: the MC step's counters iter_sum /
frames over the calls of the traced window."""


def read(view):
    r = view.readings
    if not r.get("frames"):
        return None
    return r["frame_iters"] / r["frames"]
