"""The least time a decode could take on the card: the roofline arithmetic
of the program's chip checks (``chip_smoke.py::_bound_ms``), copied.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.

Operations per edge and iteration of a frame, counting tanh and log as
one each, one compare for a scan that tests its largest kept value first,
and sign and index selects as free: min-sum q = p - R, |q|, the min
compare, max(m - beta, 0), alpha *, sign *, the VN add (7);
sumproduct-fast q, |q|, the compare of the three-smallest scan, sign *,
the VN add (5) plus, per check row, three soft-min pairs of 25 each (75).
Bytes: the LLRs in (4 a bit), bits, ok and iters_used out, each once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_EDGE_ITER = {"minsum": 7, "sumproduct-fast": 5}
OPS_PER_ROW_ITER = {"sumproduct-fast": 75}


def decode_bytes(n: int, frames: int) -> int:
    """Device-memory bytes of decoding `frames` codewords of length n."""
    return frames * (n * 4 + n + 1 + 4)


def decode_ops(algo: str, E: int, Z: int, m: int,
               frame_iters: int) -> float:
    """Operations of `frame_iters` codeword-iterations (the sum of the
    iterations each frame ran) of a code with E base edges, lift Z and m
    checks."""
    return ((OPS_PER_EDGE_ITER[algo] * E * Z
             + OPS_PER_ROW_ITER.get(algo, 0) * m) * float(frame_iters))


def least_seconds(algo: str, n: int, E: int, Z: int, m: int, frames: int,
                  frame_iters: int) -> float:
    """The larger of bytes over the memory peak and operations over the
    float32 peak."""
    return max(decode_bytes(n, frames) / HBM_BYTES_PER_S,
               decode_ops(algo, E, Z, m, frame_iters) / FP32_OPS_PER_S)


# the program's flooding kernel (csrc/bp_flood.cu), by its name in a trace
FLOOD_KERNEL = "bp_flood_kernel"


def flood_roofline(view, algo: str):
    """Percent of its roofline that the flooding kernel reached over the
    traced window: least seconds of the window's decodes (``frames``
    codewords, ``frame_iters`` codeword-iterations) over the kernel's
    device seconds.  None where the window ran another algorithm, did
    not count its iterations, or the trace holds no such kernel."""
    r, tr = view.readings, view.trace
    if tr is None or r.get("algo") != algo or not r.get("frame_iters"):
        return None
    kernel_s = tr.device_seconds(lambda name: FLOOD_KERNEL in name)
    if kernel_s <= 0:
        return None
    B = view.config["code"]["B"]
    Z = int(view.config["code"]["Z"])
    E = sum(s >= 0 for row in B for s in row)
    least = least_seconds(algo, len(B[0]) * Z, E, Z, len(B) * Z,
                          r["frames"], r["frame_iters"])
    return 100.0 * least / kernel_s
