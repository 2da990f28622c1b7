"""The layered min-sum kernel's share of its roofline in decode-only
traffic: the least time of the window's decodes
(``roofline.least_seconds``, the least time the flooding kernels'
readers use: layered min-sum does the same 7 operations an
edge-iteration) over the device seconds of the kernels named
``bp_layered_kernel`` (the shared-memory kernel; its device-memory form
is ``bp_layered_gmem_kernel``, another name).  None where the window ran
another algorithm, did not count its iterations, or the trace holds no
such kernel."""

from ldpcbench.roofline import least_seconds

KERNEL = "bp_layered_kernel"


def read(view):
    r, tr = view.readings, view.trace
    if tr is None or r.get("algo") != "minsum" or not r.get("frame_iters"):
        return None
    kernel_s = tr.device_seconds(lambda name: KERNEL in name)
    if kernel_s <= 0:
        return None
    B = view.config["code"]["B"]
    Z = int(view.config["code"]["Z"])
    E = sum(s >= 0 for row in B for s in row)
    least = least_seconds("minsum", len(B[0]) * Z, E, Z, len(B) * Z,
                          r["frames"], r["frame_iters"])
    return 100.0 * least / kernel_s
