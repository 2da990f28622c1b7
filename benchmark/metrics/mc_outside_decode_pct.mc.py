"""Share of the device's busy time spent outside the decode kernels: the
device time of operations that are not the program's decode kernels
(``bp_*_kernel`` of its CUDA sources) over all device time in the traced
window.  Outside: the draws, the encoder and channel (``mc_encode_llr``),
the counters (``mc_count``) and any copy."""

import os

from ldpcbench.harness import decode_kernel_names


def read(view):
    import tpu_ldpc_torch

    tr = view.trace
    if tr is None:
        return None
    names = decode_kernel_names(
        os.path.join(os.path.dirname(tpu_ldpc_torch.__file__), "csrc"))
    total = tr.device_seconds(lambda n: True)
    if total <= 0 or not names:
        return None
    outside = tr.device_seconds(lambda n: not any(k in n for k in names))
    return 100.0 * outside / total
