"""LdpcCode: the host-side code object (the port's copy of
``tpu_ldpc/codes/code.py``).

Pure NumPy.  The device side sees only the frozen arrays it derives
(base matrix, Tanner layout, generator parity map), through
``codes_device.to_device``.  ``LdpcCode.from_base_graph(B, Z, name)``
carries a code of the JAX package across: the same B, Z and name give
the same H, layout and parity map.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.sparse as sp

from tpu_ldpc_torch.codes import base_graphs
from tpu_ldpc_torch.codes.expand import expand


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """A QC-LDPC code: base matrix + lift size (+ derived, cached views)."""

    name: str
    B: np.ndarray  # (mb, nb) int64, -1 = zero block, else shift in [0, Z)
    Z: int

    def __post_init__(self):
        B = np.asarray(self.B, dtype=np.int64)
        B.setflags(write=False)
        object.__setattr__(self, "B", B)

    # --- shape ----------------------------------------------------------
    @property
    def mb(self) -> int:
        return self.B.shape[0]

    @property
    def nb(self) -> int:
        return self.B.shape[1]

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    # --- derived artifacts (cached) -------------------------------------
    @functools.cached_property
    def H(self) -> sp.csr_matrix:
        return expand(self.B, self.Z)

    @functools.cached_property
    def parity_M(self) -> np.ndarray:
        """(m x k) GF(2) map p = M @ u (the generator encoder's matrix);
        raises ValueError when the trailing parity block is singular."""
        from tpu_ldpc_torch.codes.gf2 import parity_map

        return parity_map(self.H)

    @functools.cached_property
    def layout(self):
        """The Tanner layout every decoder reads (codes/layout.py)."""
        from tpu_ldpc_torch.codes.layout import compile_layout

        return compile_layout(self)

    def girth_lower_bound(self) -> int:
        return base_graphs.girth_lower_bound(self.B, self.Z)

    def __hash__(self):
        return hash((self.name, self.Z, self.B.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, LdpcCode)
            and self.name == other.name
            and self.Z == other.Z
            and np.array_equal(self.B, other.B)
        )

    # --- constructors ----------------------------------------------------
    @staticmethod
    def judged() -> "LdpcCode":
        """The judged (1024, 512) rate-1/2 code (BASELINE.json config 1)."""
        return LdpcCode("qc1024_r12", base_graphs.judged_base_graph(), 64)

    @staticmethod
    def from_family(family: str, rate: str, Z: int) -> "LdpcCode":
        B = base_graphs.family_base_graph(family, rate, Z)
        return LdpcCode(f"{family}_r{rate.replace('/', '')}_z{Z}", B, Z)

    @staticmethod
    def from_base_graph(B: np.ndarray, Z: int, name: str = "custom") -> "LdpcCode":
        return LdpcCode(name, np.asarray(B), Z)
