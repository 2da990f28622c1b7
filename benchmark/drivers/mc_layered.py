"""Monte-Carlo traffic of the layered schedule: ``mc.py``'s set-up and
window as they are (the traffic's ``schedule`` reaches the program's
``DecodeCfg``), checked against the layered reference
(``ldpcbench/reference_layered.py``) in place of the flooding one.

Traffic keys, end-to-end metric and checks: those of ``mc.py``
(counters_off over the sampled calls, frames_off over the window).  The
control is the layered reference with bf16 message storage.
"""

from __future__ import annotations

import os

import numpy as np

from ldpcbench import reference
from ldpcbench.harness import load_module
from ldpcbench.reference_layered import LayeredDecoder

_mc = load_module(os.path.join(os.path.dirname(__file__), "mc.py"),
                  "ldpcbench_driver_mc")
setup, measure, LIMITS = _mc.setup, _mc.measure, _mc.LIMITS


def _reference_counters(ctx, calls, msg_bf16=False):
    t = ctx.traffic
    dec = LayeredDecoder(ctx.ref_code, t["algo"], t["iters"], t["alpha"],
                         True, msg_bf16=msg_bf16)
    mc = reference.MonteCarlo(ctx.ref_code, dec, t["batch"],
                              ctx.config["puncture_blocks"], ctx.device)
    spc = int(t["steps_per_call"])
    return np.stack([mc.call_counters(ctx.seed, 0, spc * i, spc,
                                      float(t["ebn0_db"])) for i in calls])


def check(ctx, st):
    st.pop("step", None)
    c, t = st["counters"], ctx.traffic
    calls = _mc._sample(ctx, len(c))
    want = _reference_counters(ctx, calls)
    frames_off = int((c[:, 0] != t["steps_per_call"] * t["batch"]).sum())
    return [("counters_off", int((c[calls] != want).sum()),
             LIMITS["counters_off"]),
            ("frames_off", frames_off, LIMITS["frames_off"])]


def control(ctx, st):
    """counters_off of the layered reference with bf16 message storage in
    the program's place, over the same sampled calls."""
    calls = _mc._sample(ctx, len(st["counters"]))
    want = _reference_counters(ctx, calls)
    got = _reference_counters(ctx, calls, msg_bf16=True)
    return [("counters_off", int((got != want).sum()))]
