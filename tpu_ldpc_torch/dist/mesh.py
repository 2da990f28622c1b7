"""Distributed Monte-Carlo over ranks (port of ``tpu_ldpc/dist/mesh.py``).

One process per rank, a ``torch.distributed`` process group in place of
the JAX device mesh, one ``all_reduce`` of the six error counters in
place of ``psum``, and ``torchrun`` (``cli/launch.py``) in place of
``jax.distributed.initialize``.

Backends: NCCL when the ranks compute on the card (rank ``LOCAL_RANK``
on ``cuda:LOCAL_RANK``, one card per rank), gloo on the CPU.  A caller
may name gloo for ranks that compute on the card; every collective then
stages its tensor through the host (``Mesh.comm_device``).  That is a
property of the backend, chosen by the caller, never a fallback: when
NCCL cannot start, ``init_distributed`` raises.

SPMD rule (the counterpart of the JAX package's ``lax.switch`` landmine):
every rank issues the same collectives, in the same order, the same
number of times; code that differs between ranks holds only local work;
a loop ends early only on all-reduced counts, which every rank holds
alike.  Ranks therefore make the same stop decisions.

PRNG rule: each batch's generator is seeded from (seed, snr_idx,
batch_ctr, rank) (``fold_generator_rank``), so an N-rank run draws a
superset of the streams of any smaller run, and rank 0 draws the
single-device stream of ``sim/mc.py::batch_generator``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_ldpc_torch.codes_device import resolve_device
from tpu_ldpc_torch.spans import span, spanned


def init_distributed(backend: str | None = None, device="cuda", **kw):
    """Join the process group of this run (a no-op when one exists).

    Under ``torchrun`` (``RANK`` in the environment) it rendezvouses
    through ``MASTER_ADDR`` / ``MASTER_PORT`` (``init_method='env://'``);
    otherwise it makes a group of one on an in-process ``HashStore``, so
    a mesh on one process works as the JAX package's one-process mesh.

    backend: None picks NCCL for `device` 'cuda' and gloo for 'cpu';
    gloo may be named for ranks on the card.  With NCCL, rank
    ``LOCAL_RANK`` computes on ``cuda:LOCAL_RANK``: more ranks on a host
    than cards, or a `device` that names another card, raises before
    NCCL is asked.  kw goes to ``init_process_group`` (for example
    ``timeout``, a timedelta)."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("backend 'nccl' requested but this PyTorch "
                               "build has no NCCL")
        local_ranks = int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise RuntimeError(
                f"more ranks than cards: {local_ranks} ranks on this host, "
                f"{cards} CUDA device(s); NCCL needs one card per rank (name "
                "backend='gloo' to share a card, its collectives staged "
                "through the host)")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if device.type == "cuda" and device.index not in (None, local):
            raise ValueError(
                f"rank LOCAL_RANK={local} computes on cuda:{local} under "
                f"NCCL, not on {device}: name the device 'cuda'")
        torch.cuda.set_device(local)
    if "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of one process group: this rank's place in it, the
    device it computes on and the device its collectives run on (the
    card under NCCL, the CPU under gloo)."""

    group: object          # a ProcessGroup, or None for the world group
    rank: int
    size: int
    device: torch.device
    comm_device: torch.device

    def _staged(self, x: torch.Tensor, op) -> torch.Tensor:
        """op(x on comm_device, contiguous) moved back to x's device: the
        one road of every collective below.  x may serve as the buffer."""
        return op(x.to(self.comm_device).contiguous()).to(x.device)

    def _global(self, group_rank: int) -> int:
        return (group_rank if self.group is None
                else dist.get_global_rank(self.group, group_rank))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks, on every rank."""
        def op(y):
            dist.all_reduce(y, group=self.group)
            return y
        return self._staged(x, op)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): x of every rank, in rank order."""
        def op(y):
            out = [torch.empty_like(y) for _ in range(self.size)]
            dist.all_gather(out, y, group=self.group)
            return torch.stack(out)
        return self._staged(x, op)

    def shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Send x to rank + step and return what rank - step sent: zeros
        where no such rank exists (``ppermute``'s rule).  Sends and
        receives go in one ``batch_isend_irecv``, so neighbours cannot
        deadlock."""
        src, dst = self.rank - step, self.rank + step

        def op(y):
            got = torch.zeros_like(y)
            ops = []
            if 0 <= dst < self.size:
                ops.append(dist.P2POp(dist.isend, y, self._global(dst),
                                      self.group))
            if 0 <= src < self.size:
                ops.append(dist.P2POp(dist.irecv, got, self._global(src),
                                      self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return got
        return self._staged(x, op)


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of `group` (None: every rank; a sub-mesh is
    ``dist.new_group(ranks)``, made by every rank, the counterpart of
    ``make_mesh(jax.devices()[:4])``).  device: where this rank
    computes; None is its card under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this rank is not a member of the group")
    if dist.get_backend(group) == "nccl":
        comm = torch.device("cuda", torch.cuda.current_device())
    else:
        comm = torch.device("cpu")
    if device is None:
        device = comm
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, dist.get_world_size(group), device, comm)


def fold_generator_rank(seed: int, snr_idx: int, batch_ctr: int, rank: int,
                        device) -> torch.Generator:
    """The generator of one rank's batch, seeded from
    ``SeedSequence([seed, snr_idx, batch_ctr, rank])`` by the rule of
    ``sim/mc.py::batch_generator``.  A trailing 0 leaves a SeedSequence's
    state unchanged, so rank 0 draws the single-device stream, and an
    N-rank run draws a superset of the streams of any smaller one.

    The JAX package folds the device index into its key on every device,
    device 0 included, so its device 0 does not draw its single-device
    stream; the draws differ from it anyway (Philox / Mersenne Twister
    against Threefry)."""
    with span("ldpc.mc.seed"):
        state = np.random.SeedSequence(
            [seed, snr_idx, batch_ctr, rank]).generate_state(1, np.uint64)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state[0] >> np.uint64(1)))
        return gen


@functools.lru_cache(maxsize=64)
@spanned("ldpc.build")
def build_sharded_mc_step(code, cfg, per_rank_batch: int, mesh: Mesh,
                          steps_per_call: int = 1, adapt=None, crc=None):
    """SPMD MC step: (seed, snr_idx, ebn0_db, ctr0) -> (6,) int64 counters
    on the rank's device, summed over `steps_per_call` batches of every
    rank (batches ctr0 .. ctr0 + steps_per_call - 1, each rank on its own
    generators) by one all_reduce a call.  Every rank gets the same
    totals, so every rank's host loop makes the same stop decisions.
    The batch (encode, channel with `adapt`, decode, count, `crc`) is
    ``sim/mc.py::BatchFn``, the single-device step's."""
    from tpu_ldpc_torch.sim.mc import BatchFn

    device = mesh.device
    one_batch = BatchFn(code, cfg, per_rank_batch, device, adapt, crc)

    @spanned("ldpc.mc.call")
    def step(seed: int, snr_idx: int, ebn0_db: float, ctr0: int):
        acc = torch.zeros(6, dtype=torch.int64, device=device)
        for t in range(steps_per_call):
            with span("ldpc.mc.batch"):
                gen = fold_generator_rank(seed, snr_idx, ctr0 + t,
                                          mesh.rank, device)
                one_batch(gen, ebn0_db, acc)
        with span("ldpc.mc.allreduce"):
            return mesh.all_reduce(acc)  # the one collective of a call

    step.k = one_batch.k  # effective info bits per frame
    return step


def run_ber_sharded(code, ebn0_grid: Sequence[float], cfg, batch: int,
                    target_frame_errors: int, max_frames: int, seed: int,
                    mesh: Mesh, progress: bool = False,
                    state=None, steps_per_call: int | None = None,
                    step_log: str | None = None, adapt=None, crc=None):
    """Frame-error-targeted sweep over the mesh (the host loop of
    ``sim/mc.py::run_ber`` on replicated counters).

    `batch` is the per-rank batch: a call decodes batch * mesh.size *
    steps_per_call frames.  Every rank runs this loop and sees the same
    totals; the step log and progress lines come from rank 0 only, and
    every rank saves the same checkpoint state (atomically)."""
    from tpu_ldpc_torch.sim.mc import (
        COUNTER_FIELDS, SnrResult, _log_step, default_steps_per_call)

    if steps_per_call is None:
        steps_per_call = default_steps_per_call(mesh.device)
    step = build_sharded_mc_step(code, cfg, batch, mesh, steps_per_call,
                                 adapt, crc)
    results = []
    for snr_idx, ebn0 in enumerate(ebn0_grid):
        with span("ldpc.mc.point"):
            res = SnrResult(ebn0_db=float(ebn0))
            batch_ctr = 0
            if state is not None:
                saved = state.load_point(snr_idx)
                if saved is not None:
                    res, batch_ctr = saved
            t0 = time.perf_counter()
            while (res.frame_errors < target_frame_errors
                   and res.frames < max_frames):
                acc = step(seed, snr_idx, float(ebn0), batch_ctr)
                with span("ldpc.mc.read"):
                    counters = acc.tolist()
                for name, v in zip(COUNTER_FIELDS, counters):
                    setattr(res, name, getattr(res, name) + int(v))
                batch_ctr += steps_per_call
                if state is not None:
                    state.save_point(snr_idx, res, batch_ctr)
                if step_log is not None and mesh.rank == 0:
                    _log_step(step_log, res, t0, step.k)
            res.wall_s += time.perf_counter() - t0
            res.bits = res.frames * step.k
        results.append(res)
        if progress and mesh.rank == 0:
            print(f"Eb/N0 {ebn0:5.2f} dB [{mesh.size} ranks]: "
                  f"frames={res.frames} FER={res.fer:.3e} BER={res.ber:.3e} "
                  f"mean_iters={res.mean_iters:.1f}")
    return results
