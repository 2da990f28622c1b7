"""Grid-sharded Monte-Carlo: Eb/N0 points x batches over the ranks (port
of ``tpu_ldpc/dist/grid.py``).

The data-parallel path (``dist/mesh.py``) puts every rank on the same
Eb/N0 point, which wastes ranks near the end of a sweep: low-FER points
need millions of frames while high-FER points finished long ago.  Here
each rank is a slot that the host scheduler hands one (snr_idx,
batch_ctr) cell per call, round robin over the unfinished points.

PRNG rule: a cell draws from ``sim/mc.py::batch_generator(seed, snr_idx,
ctr)`` with no rank folded in (the JAX package folds device 0 on
purpose), and the scheduler hands out strictly increasing ctrs per
point, so a point's counters are exactly those of the single-device
batches with the same ctrs: scheduling changes who computes a batch,
never which batches exist.  The rows come back through one
``all_gather`` a call (no reduction); every rank runs the same scheduler
on the same rows, so every rank makes the same decisions.
"""

from __future__ import annotations

import functools
import time
from typing import Sequence

import torch

from tpu_ldpc_torch.dist.mesh import Mesh


@functools.lru_cache(maxsize=64)
def build_grid_mc_step(code, cfg, batch: int, mesh: Mesh):
    """SPMD step: (seed, snr_idx, ebn0_db, ctr), each a sequence of one
    cell per rank -> (mesh.size, 6) int64 counter rows on the rank's
    device, row r the cell of rank r.  Each rank computes its own cell."""
    from tpu_ldpc_torch.sim.mc import BatchFn, batch_generator

    one_batch = BatchFn(code, cfg, batch, mesh.device)

    def step(seed: int, snr_idx: Sequence[int], ebn0_db: Sequence[float],
             ctr: Sequence[int]) -> torch.Tensor:
        r = mesh.rank
        gen = batch_generator(seed, snr_idx[r], ctr[r], mesh.device)
        return mesh.all_gather(one_batch(gen, float(ebn0_db[r])))

    step.k = one_batch.k
    return step


def run_ber_grid(code, ebn0_grid: Sequence[float], cfg, batch: int = 256,
                 target_frame_errors: int = 100, max_frames: int = 1_000_000,
                 seed: int = 0, mesh: Mesh = None, progress: bool = False):
    """Frame-error-targeted sweep with (Eb/N0, batch) cells over the
    ranks.  wall_s is the sweep's wall time split evenly over the
    points."""
    from tpu_ldpc_torch.sim.mc import COUNTER_FIELDS, SnrResult

    n_ranks = mesh.size
    step = build_grid_mc_step(code, cfg, batch, mesh)
    results = [SnrResult(ebn0_db=float(e)) for e in ebn0_grid]
    next_ctr = [0] * len(ebn0_grid)
    t0 = time.perf_counter()

    def unfinished():
        return [
            i for i, r in enumerate(results)
            if r.frame_errors < target_frame_errors and r.frames < max_frames
        ]

    rr = 0
    while True:
        active = unfinished()
        if not active:
            break
        # round-robin assignment of the active points to the rank slots
        assignment = []
        for s in range(n_ranks):
            p = active[(rr + s) % len(active)]
            assignment.append((p, next_ctr[p]))
            next_ctr[p] += 1
        rr += n_ranks
        rows = step(seed, [a[0] for a in assignment],
                    [ebn0_grid[a[0]] for a in assignment],
                    [a[1] for a in assignment]).tolist()
        for (p, _), row in zip(assignment, rows):
            r = results[p]
            for name, v in zip(COUNTER_FIELDS, row):
                setattr(r, name, getattr(r, name) + int(v))
    wall = time.perf_counter() - t0
    for r in results:
        r.bits = r.frames * step.k
        r.wall_s = wall / len(results)
        if progress and mesh.rank == 0:
            print(f"Eb/N0 {r.ebn0_db:5.2f} dB [grid x{n_ranks}]: "
                  f"frames={r.frames} FER={r.fer:.3e} BER={r.ber:.3e}")
    return results
