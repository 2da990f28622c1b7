"""Monte-Carlo BER/FER harness (L3)."""

from tpu_ldpc_torch.sim.mc import (  # noqa: F401
    DecodeCfg,
    SnrResult,
    build_batch_fn,
    build_mc_step,
    run_ber,
)
from tpu_ldpc_torch.sim.search import (  # noqa: F401
    FerSearchResult,
    find_ebn0_at_fer,
)
