"""One rank of the port's distributed tests (tests/test_torch_dist.py).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r LOCAL_WORLD_SIZE=n MASTER_ADDR=127.0.0.1 \
        MASTER_PORT=p python tests/torch_dist_worker.py inputs.npz out_dir

Joins a gloo group through the torchrun environment variables, computes
every distributed result the tests check on the CPU and pickles them to
out_dir/rank<r>.pkl.  It imports only tpu_ldpc_torch (no JAX)."""

import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes import make_base_graph
from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
from tpu_ldpc_torch.dist import (
    build_sharded_mc_step, init_distributed, make_mesh)
from tpu_ldpc_torch.dist.grid import run_ber_grid
from tpu_ldpc_torch.dist.partitioned import build_partitioned_decoder
from tpu_ldpc_torch.dist.ring import build_ring_decoder
from tpu_ldpc_torch.sim.mc import DecodeCfg, run_ber


def toy_code():
    return LdpcCode.from_base_graph(make_base_graph(4, 8, 4, seed=7), 4,
                                    "toy")


def rows(results):
    """SnrResults as dicts, without their (per-rank) wall time."""
    return [{k: v for k, v in dataclasses.asdict(r).items() if k != "wall_s"}
            for r in results]


def numpy_of(out):
    return tuple(x.numpy() for x in out)


def main(inputs, out_dir):
    torch.set_num_threads(1)
    init_distributed(device="cpu", timeout=datetime.timedelta(seconds=60))
    world = dist.get_world_size()
    rank = dist.get_rank()
    data = np.load(inputs)
    toy = toy_code()
    mesh = make_mesh(device="cpu")
    out = {"rank": rank, "world": world, "mesh": (mesh.rank, mesh.size)}
    out["step"] = build_sharded_mc_step(
        toy, DecodeCfg(iters=20), 16, mesh, steps_per_call=2)(
            3, 1, 4.0, 2).tolist()
    out["run_ber"] = rows(run_ber(
        toy, [3.0, 6.0], DecodeCfg(iters=20), batch=16,
        target_frame_errors=8, max_frames=512, seed=5, mesh=mesh,
        device="cpu"))
    out["grid"] = rows(run_ber_grid(
        toy, [2.0, 5.0, 8.0], DecodeCfg(iters=15), batch=16,
        target_frame_errors=6, max_frames=256, seed=4, mesh=mesh))
    # a sub-mesh of rank 0 alone: every rank makes the group
    sub = dist.new_group([0])
    if rank == 0:
        out["sub_run_ber"] = rows(run_ber(
            toy, [3.0], DecodeCfg(iters=20), batch=16, target_frame_errors=8,
            max_frames=256, seed=5, mesh=make_mesh(sub, device="cpu"),
            device="cpu"))
    if world == 4:
        sc8 = LdpcCode.from_base_graph(make_sc_base_graph(8, 8, seed=5), 8,
                                       "sc8")
        w3 = LdpcCode(name="banded-w3", B=data["B_w3"], Z=8)
        llr_sc8 = torch.from_numpy(data["llr_sc8"])
        out["ring_sc8_minsum"] = numpy_of(
            build_ring_decoder(sc8, mesh, iters=20)(llr_sc8))
        out["ring_sc8_sumproduct"] = numpy_of(build_ring_decoder(
            sc8, mesh, algo="sumproduct", iters=20)(llr_sc8))
        out["ring_w3_minsum"] = numpy_of(build_ring_decoder(
            w3, mesh, iters=15)(torch.from_numpy(data["llr_w3"])))
        fn = build_partitioned_decoder(toy, mesh, iters=20)
        llr_toy = torch.from_numpy(data["llr_toy"])
        out["partitioned_toy"] = [numpy_of(fn(llr_toy)) for _ in range(2)]
    dist.barrier()
    dist.destroy_process_group()
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "tpu_ldpc"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
