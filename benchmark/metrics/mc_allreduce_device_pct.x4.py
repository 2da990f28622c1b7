"""Share of rank 0's traced window in which its card ran NCCL's
all-reduce kernels: the sharded step's all-reduce of the counters (the
window's only NCCL work; the stop flag goes over gloo on the host), so
the collective's own time and its wait for the slowest rank."""


def read(view):
    tr = view.trace
    if tr is None or tr.window_s <= 0:
        return None
    nccl = tr.device_seconds(lambda n: n.startswith("nccl")
                             and "AllReduce" in n)
    if nccl <= 0:
        return None
    return 100.0 * nccl / tr.window_s
