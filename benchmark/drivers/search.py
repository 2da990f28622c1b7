"""Operating-point searches: back-to-back calls of the program's
``sim/search.py::find_ebn0_at_fer`` (bisection on Eb/N0 for a target FER,
every probe a frame-error-targeted ``run_ber`` point); search i is seeded
with ``traffic.search_seed(seed, i)``.

Traffic keys: algo, iters, alpha, schedule, batch, steps_per_call (the
program's batches a host read on the card), target_fer, lo_db, hi_db,
tol_db, target_frame_errors, max_frames, check_probes (probes recomputed
by the reference, drawn from the seed after the window).

End to end: fer_search_s = window seconds / searches completed.  Checks:
bisection_off, the searches whose probe points, bracket or convergence do
not follow the bisection from their own probes' FERs (every search of the
window); counters_off, the counters of the sampled probes that differ from
the reference's.  A search that does not converge counts as failed.
"""

from __future__ import annotations

import time

import numpy as np

from ldpcbench import reference
from ldpcbench.trace import WINDOW
from ldpcbench.traffic import search_seed

LIMITS = {"bisection_off": 0, "counters_off": 0}
FIELDS = reference.COUNTERS


def _search(ctx, st, i):
    from tpu_ldpc_torch.sim.search import find_ebn0_at_fer

    t = ctx.traffic
    seed = search_seed(ctx.seed, i)
    r = find_ebn0_at_fer(
        st["code"], t["target_fer"], st["cfg"], lo=t["lo_db"], hi=t["hi_db"],
        tol_db=t["tol_db"], target_frame_errors=t["target_frame_errors"],
        max_frames=t["max_frames"], batch=t["batch"], seed=seed,
        device=ctx.device)
    return {"seed": seed, "points": [p.ebn0_db for p in r.probes],
            "counters": [[getattr(p, f) for f in FIELDS] for p in r.probes],
            "bracket": tuple(r.bracket), "converged": bool(r.converged)}


def setup(ctx):
    from tpu_ldpc_torch.sim.mc import DecodeCfg, default_steps_per_call

    t = ctx.traffic
    if default_steps_per_call(ctx.device) != t["steps_per_call"]:
        raise ValueError(
            f"the program reads the counters every "
            f"{default_steps_per_call(ctx.device)} batches on "
            f"{ctx.device}, the traffic says {t['steps_per_call']}")
    st = {"code": ctx.program_code(),
          "cfg": DecodeCfg(algo=t["algo"], iters=t["iters"],
                           alpha=t["alpha"], schedule=t["schedule"])}
    _search(ctx, st, 0)
    return st


def measure(ctx, st):
    runs = []
    t0 = time.perf_counter()
    with ctx.tracer.span(WINDOW):
        while True:
            with ctx.tracer.span("bench.search"):
                runs.append(_search(ctx, st, len(runs)))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    wall = time.perf_counter() - t0
    st["runs"] = runs
    probes = sum(len(r["points"]) for r in runs)
    frames = sum(c[0] for r in runs for c in r["counters"])
    return {"attempted": len(runs),
            "failed": sum(not r["converged"] for r in runs),
            "metrics": {"fer_search_s": wall / len(runs)},
            "readings": {"searches": len(runs), "probes": probes,
                         "frames": frames,
                         "frame_iters": sum(c[5] for r in runs
                                            for c in r["counters"]),
                         "algo": ctx.traffic["algo"]}}


def _bisection_off(ctx, run) -> bool:
    t = ctx.traffic
    fers = dict(zip(run["points"],
                    (c[2] / max(c[0], 1) for c in run["counters"])))
    try:
        points, bracket, converged = reference.bisection(
            fers.__getitem__, t["target_fer"], t["lo_db"], t["hi_db"],
            t["tol_db"])
    except KeyError:  # the bisection asks for a point never probed
        return True
    return (points != run["points"] or tuple(bracket) != run["bracket"]
            or converged != run["converged"])


def _sample(ctx, runs):
    probes = [(i, j) for i, r in enumerate(runs)
              for j in range(len(r["points"]))]
    rng = np.random.default_rng([ctx.seed, 3])
    k = min(int(ctx.traffic["check_probes"]), len(probes))
    return [probes[int(x)] for x in sorted(rng.choice(len(probes), size=k,
                                                      replace=False))]


def _reference_counters(ctx, runs, probes, msg_bf16=False):
    t = ctx.traffic
    dec = reference.Decoder(ctx.ref_code, t["algo"], t["iters"], t["alpha"],
                            True, msg_bf16=msg_bf16)
    mc = reference.MonteCarlo(ctx.ref_code, dec, t["batch"],
                              ctx.config["puncture_blocks"], ctx.device)
    return np.stack([mc.point(runs[i]["seed"], runs[i]["points"][j],
                              t["target_frame_errors"], t["max_frames"],
                              int(t["steps_per_call"]))
                     for i, j in probes])


def check(ctx, st):
    st.pop("code", None)
    runs = st["runs"]
    probes = _sample(ctx, runs)
    got = np.asarray([runs[i]["counters"][j] for i, j in probes])
    want = _reference_counters(ctx, runs, probes)
    return [("bisection_off", sum(_bisection_off(ctx, r) for r in runs),
             LIMITS["bisection_off"]),
            ("counters_off", int((got != want).sum()),
             LIMITS["counters_off"])]


def control(ctx, st):
    """counters_off of the reference with bf16 message storage in the
    program's place, over the same sampled probes."""
    runs = st["runs"]
    probes = _sample(ctx, runs)
    want = _reference_counters(ctx, runs, probes)
    got = _reference_counters(ctx, runs, probes, msg_bf16=True)
    return [("counters_off", int((got != want).sum()))]
