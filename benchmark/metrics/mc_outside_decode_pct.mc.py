"""Share of the device's busy time spent outside the decode kernels: the
device time of operations that are not kernels of the program's CUDA
sources (draws, encoder, channel, counters, copies) over all device time
in the traced window."""

import os

from ldpcbench.harness import program_kernel_names


def read(view):
    import tpu_ldpc_torch

    tr = view.trace
    if tr is None:
        return None
    names = program_kernel_names(
        os.path.join(os.path.dirname(tpu_ldpc_torch.__file__), "csrc"))
    total = tr.device_seconds(lambda n: True)
    if total <= 0 or not names:
        return None
    outside = tr.device_seconds(lambda n: not any(k in n for k in names))
    return 100.0 * outside / total
