"""Distributed execution over ranks: process groups, the sharded MC
step with all-reduced counters, the grid-sharded sweep, the partitioned
and ring decoders (port of ``tpu_ldpc/dist``)."""

from tpu_ldpc_torch.dist.mesh import (  # noqa: F401
    Mesh,
    build_sharded_mc_step,
    fold_generator_rank,
    init_distributed,
    make_mesh,
    run_ber_sharded,
)
