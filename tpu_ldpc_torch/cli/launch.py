"""`python -m tpu_ldpc_torch.cli.launch` -- multi-process launcher (port of
``tpu_ldpc/cli/launch.py``).  ``torchrun`` starts one process per rank;
each joins the process group (``dist/mesh.py::init_distributed``) and
runs the sweep CLI with ``--mesh``:

    # one host, 4 cards (NCCL, one card per rank):
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m tpu_ldpc_torch.cli.launch -- --family judged --ebn0 2.0

    # CPU ranks (gloo):
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m tpu_ldpc_torch.cli.launch -- --family judged --device cpu

    # several hosts: the same command on every host
    python -m torch.distributed.run --nnodes 2 --node-rank $i \\
        --master-addr host0 --master-port 1234 --nproc-per-node 4 \\
        -m tpu_ldpc_torch.cli.launch -- ...

The JAX launcher's ``COORD`` / ``NPROC`` / ``PROC_ID`` variables map
onto torchrun's own flags: ``--master-addr`` / ``--master-port``,
``--nnodes`` x ``--nproc-per-node``, ``--node-rank`` (torchrun then sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` for each process).  The sweep
CLI joins the group (``--mesh``) and prints each process's
``[launch] process r/N`` line; the backend follows ``--device``: NCCL on
the card (more ranks on a host than cards raises), gloo on the CPU.
Rank 0 writes the reports; every rank makes the same stop decisions
from the all-reduced counters.
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if "--mesh" not in argv:
        argv.append("--mesh")

    import torch.distributed as dist

    from tpu_ldpc_torch.cli.sim import main as sim_main

    try:
        return sim_main(argv)  # joins the group and prints the rank line
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
