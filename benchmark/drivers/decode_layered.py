"""Decode-only traffic of the layered schedule: ``decode.py``'s set-up and
window as they are (the traffic's ``schedule`` reaches the program's
throughput decoder), checked against the layered reference
(``ldpcbench/reference_layered.py``) in place of the flooding one.

Traffic keys, end-to-end metric and check: those of ``decode.py``
(frames_off over the kept calls).  The control is the layered reference
with bf16 message storage.
"""

from __future__ import annotations

import os

from ldpcbench.harness import load_module
from ldpcbench.reference_layered import LayeredDecoder

_decode = load_module(os.path.join(os.path.dirname(__file__), "decode.py"),
                      "ldpcbench_driver_decode")
setup, measure, LIMITS = _decode.setup, _decode.measure, _decode.LIMITS


def _reference(ctx, st, msg_bf16=False):
    t = ctx.traffic
    dec = LayeredDecoder(ctx.ref_code, t["algo"], t["iters"], t["alpha"],
                         t["early_stop"], msg_bf16=msg_bf16)
    return [dec(b) for b in st["bufs"]]


def check(ctx, st):
    st.pop("fn", None)
    off = _decode._frames_off(st["kept"], _reference(ctx, st))
    return [("frames_off", off, LIMITS["frames_off"])]


def control(ctx, st):
    """frames_off of the layered reference with bf16 message storage
    decoding the same buffers."""
    outs = list(enumerate(_reference(ctx, st, msg_bf16=True)))
    return [("frames_off", _decode._frames_off(outs, _reference(ctx, st)))]
