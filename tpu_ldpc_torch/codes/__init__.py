"""Code construction: base graphs, QC lifting, layout compiler, GF(2)
algebra and code-file I/O (NumPy / SciPy; the port's own copies of the
JAX package's framework-free modules, with the same names)."""

from tpu_ldpc_torch.codes.base_graphs import (  # noqa: F401
    FAMILY_LIFTS,
    count_4cycles,
    count_6cycles,
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
