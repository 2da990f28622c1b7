"""Code construction: base graphs, QC lifting, layout compiler, GF(2)
algebra, code-file I/O, the NR-like rate-compatible family, the outer
CRC, and construction / analysis tools (annealing, PEG, PEXIT, d_min,
trapping-set census) -- NumPy / SciPy and the native host helper; the
port's own copies of the JAX package's framework-free modules, with the
same names."""

from tpu_ldpc_torch.codes.base_graphs import (  # noqa: F401
    FAMILY_LIFTS,
    ace8_cost,
    count_4cycles,
    count_6cycles,
    count_8cycles,
    count_8cycles_raw,
    family_base_graph,
    girth_lower_bound,
    judged_base_graph,
    make_base_graph,
    make_sc_base_graph,
    select_shifts,
)
from tpu_ldpc_torch.codes.code import LdpcCode  # noqa: F401
from tpu_ldpc_torch.codes.expand import expand, rotate  # noqa: F401
from tpu_ldpc_torch.codes.nrlike import (  # noqa: F401
    make_nrlike_base_graph,
    nrlike_adapt,
    nrlike_code,
)
