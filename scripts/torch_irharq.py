"""IR-HARQ operating curves and delivered throughput on the H100, the twin
of scripts/tpu_irharq.py.  Imports only tpu_ldpc_torch.

Per ladder (BG1 kb=22 stages m 7/10/13/24, BG2 kb=10 stages
7/12/17/27/42; Z=64) and Eb/N0 point:

  * sim/harq.py::run_irharq (b=4096, min-sum 50 iterations, CRC-24
    gated delivery, seed 0; the CUDA kernel on the card): stage FERs,
    the genie column, false ACKs;
  * each stage code's decode cost at the stage's true channel: one
    benchcore timer a stage code (make_timer(code_m, 4096, n_punct=128):
    the 2Z punctured positions erased), timed by LoopTimer.measure_at at
    sigma from the first transmission's payload rate, the decoder that
    run_irharq decodes that stage with (decode.api.build_decode_fn);
  * delivered info bits/s: with per-lane active-set batching (stage s
    costs its occupancy p_s, the share still NACKed, times its cost t_s;
    a stage below MIN_OCC may go untimed) and the full-vector lower
    bound (every stage decodes every lane, as run_irharq does).

    python scripts/torch_irharq.py                  # the card

writes artifacts/h100_irharq.json (--out PATH elsewhere; atomic, after
each point).
--device cpu runs the plain decoder (a rehearsal; host times).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "artifacts", "h100_irharq.json")

Z = 64
BATCH = 4096
ITERS = 50
ALPHA = 0.75
SEED = 0
CRC = "crc24"
CRC_BITS = 24
MIN_OCC = 5e-4
REPS = 30
# ladder -> (stage_m, points, stage cell rates), scripts/tpu_irharq.py's
LADDERS = {
    1: {"stage_m": (7, 10, 13, 24), "points": (2.0, 3.0, 4.0),
        "rates": ("5/6", "3/4", "2/3", "1/2")},
    2: {"stage_m": (7, 12, 17, 27, 42), "points": (0.5, 1.5, 3.0),
        "rates": ("2/3", "1/2", "2/5", "2/7", "1/5")},
}


def first_rate(kb: int, stage_m, z: int) -> float:
    """The first transmission's payload rate, which every stage's Eb/N0
    references: (kb Z - 24) / ((kb + m_0 - 2) Z)."""
    return (kb * z - CRC_BITS) / ((kb + stage_m[0] - 2) * z)


def throughput(stage_timing, residual_fer: float, k_payload: int) -> dict:
    """The effective delivered info Gb/s of one point from its stages'
    {"occ", "s_per_frame"} (a stage without "s_per_frame" was not
    timed): active-set batching sum_s p_s t_s, None when a stage at or
    above MIN_OCC is untimed; full vector sum_s t_s, None when any
    stage is untimed."""
    t_lane = t_full = 0.0
    lane_ok = full_ok = True
    for st in stage_timing:
        if "s_per_frame" not in st:
            full_ok = False
            lane_ok = lane_ok and st["occ"] < MIN_OCC
            continue
        t_lane += st["occ"] * st["s_per_frame"]
        t_full += st["s_per_frame"]
    good = k_payload * (1 - residual_fer)
    return {"eff_info_gbps_active_batching": (
                good / t_lane / 1e9 if t_lane and lane_ok else None),
            "eff_info_gbps_full_vector": (
                good / t_full / 1e9 if t_full and full_ok else None)}


class StageTimer:
    """Each stage code's decoder and timer, built once and reused at
    every Eb/N0 of the ladder (measure_at rebuilds the LLRs)."""

    def __init__(self, bg, stage_m, z, batch, device, reps):
        from tpu_ldpc_torch.codes.code import LdpcCode
        from tpu_ldpc_torch.codes.nrlike import KB, KB2, make_nrlike_base_graph

        self.kb = KB if bg == 1 else KB2
        self.codes = [LdpcCode(f"nr{bg}_m{m}_z{z}",
                               make_nrlike_base_graph(z, m=m, kb=self.kb), z)
                      for m in stage_m]
        self.stage_m, self.z, self.batch = tuple(stage_m), z, batch
        self.device, self.reps = device, reps
        self._dec, self._timer = {}, {}

    def cost(self, si: int, ebn0: float):
        """(seconds a frame, the measure record) of stage si at the HARQ
        channel of `ebn0`."""
        from tpu_ldpc_torch.benchcore import make_timer
        from tpu_ldpc_torch.channel.awgn import noise_sigma2
        from tpu_ldpc_torch.decode.api import build_decode_fn
        from tpu_ldpc_torch.sim.mc import DecodeCfg

        if si not in self._dec:
            code = self.codes[si]
            self._dec[si] = build_decode_fn(
                code, DecodeCfg(algo="minsum", iters=ITERS, alpha=ALPHA),
                self.device)
            self._timer[si] = make_timer(code, self.batch, 2.0,
                                         device=self.device,
                                         n_punct=2 * self.z)
        sigma2 = noise_sigma2(ebn0, first_rate(self.kb, self.stage_m,
                                               self.z))
        m = self._timer[si].measure_at(self._dec[si], 2.0 / sigma2,
                                       float(np.sqrt(sigma2)), self.reps)
        return m["median_s"] / self.batch, m


def run_point(bg, spec, ebn0, stages: StageTimer, z, batch, device):
    """One Eb/N0 point of a ladder: run_irharq, then every stage timed."""
    from tpu_ldpc_torch.sim.harq import run_irharq

    t0 = time.time()
    r = run_irharq(Z=z, stage_m=spec["stage_m"], ebn0_db=ebn0, batch=batch,
                   iters=ITERS, alpha=ALPHA, seed=SEED, bg=bg, crc=CRC,
                   device=device)
    harq_s = time.time() - t0
    # the share of lanes still NACKed entering each stage; every stage is
    # timed, as the full-vector bound needs each one's cost
    occ = [1.0] + [s["fer_after"] for s in r.stages[:-1]]
    stage_t = []
    for si, p in enumerate(occ):
        t_s, meas = stages.cost(si, ebn0)
        stage_t.append({"m": spec["stage_m"][si], "occ": p,
                        "s_per_frame": t_s, "ms_per_batch":
                        meas["median_s"] * 1e3, "dec_ms": meas["dec_ms"]})
    return {
        "ebn0_db": ebn0, "stages": r.stages,
        "residual_fer": r.residual_fer, "false_acks": r.false_acks,
        "false_ack_rate": r.false_ack_rate, "frames": r.frames,
        "avg_bits_sent": r.avg_bits_sent, "avg_info_rate": r.avg_info_rate,
        "k_payload": r.k_payload, "stage_timing": stage_t,
        **throughput(stage_t, r.residual_fer, r.k_payload),
        "harq_wall_s": round(harq_s, 2),
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu runs the plain decoder")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    import torch

    from tpu_ldpc_torch.benchcore import dump_json_atomic, smi
    from tpu_ldpc_torch.codes_device import resolve_device

    device = resolve_device(args.device)
    res = {"date": time.strftime("%Y-%m-%d %H:%M"),
           "device": smi() if device.type == "cuda" else "cpu",
           "torch": torch.__version__, "Z": Z, "batch": BATCH,
           "iters": ITERS, "impl": "auto", "crc": CRC, "reps": REPS,
           "ladders": {}}
    print(f"[irharq] {res['device']}", flush=True)
    for bg, spec in LADDERS.items():
        stages = StageTimer(bg, spec["stage_m"], Z, BATCH, device, REPS)
        lad = {"stage_m": list(spec["stage_m"]),
               "stage_rates": list(spec["rates"]), "points": []}
        res["ladders"][f"bg{bg}"] = lad
        for ebn0 in spec["points"]:
            point = run_point(bg, spec, ebn0, stages, Z, BATCH, device)
            lad["points"].append(point)
            dump_json_atomic(args.out, res)
            fers = [round(s["fer_after"], 5) for s in point["stages"]]
            ms = [round(s["ms_per_batch"], 4) for s in point["stage_timing"]]
            print(f"bg{bg} {ebn0} dB: fer_stages {fers} false_acks="
                  f"{point['false_acks']} rate {point['avg_info_rate']:.4f} "
                  f"stage ms {ms} eff Gb/s active "
                  f"{point['eff_info_gbps_active_batching']} full "
                  f"{point['eff_info_gbps_full_vector']}", flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
