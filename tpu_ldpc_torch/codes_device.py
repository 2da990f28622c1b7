"""Carry a code across to a device: the LDPC counterpart of loading weights.

``to_device(code, device)`` turns the code's frozen NumPy tables
(``TannerLayout``, ``codes/layout.py``, and the generator parity map
``code.parity_M``) into tensors on ``device``.  The JAX package and this
port therefore decode the very same graph, in the same edge order:
edges sorted by (block_row, block_col); block (i, j, s) connects check
r of block-row i to variable (r + s) % Z of block-col j.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpu_ldpc.codes.code import LdpcCode


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never carries on on the CPU in its place)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False (no NVIDIA GPU or no CUDA build of PyTorch); pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceCode:
    """A code's Tanner graph as int32 tensors on one device."""

    code: LdpcCode
    device: torch.device
    edge_row: torch.Tensor    # (E,) block-row of each edge
    edge_col: torch.Tensor    # (E,) block-col of each edge
    edge_shift: torch.Tensor  # (E,) circulant shift in [0, Z)
    row_ptr: torch.Tensor     # (mb+1,) edges of row i: [row_ptr[i], row_ptr[i+1])
    col_slots: torch.Tensor   # (nb, max_col_deg) edge ids, ascending row order
    col_mask: torch.Tensor    # (nb, max_col_deg) bool validity
    col_deg: torch.Tensor     # (nb,) valid prefix length of col_slots[j]

    @property
    def E(self) -> int:
        return int(self.edge_col.shape[0])

    @functools.cached_property
    def parity_MT(self) -> torch.Tensor:
        """(k, m) float64 GF(2) generator map, p = u @ M^T mod 2.

        Raises ValueError when the trailing parity block of H is not
        invertible (rank-deficient codes take the pivot encoder)."""
        return torch.as_tensor(
            np.array(self.code.parity_M.T), dtype=torch.float64
        ).to(self.device)


@functools.lru_cache(maxsize=64)
def _to_device(code: LdpcCode, device: torch.device) -> DeviceCode:
    lay = code.layout

    def t(a, dtype=torch.int32):
        # np.array copies: the layout's arrays are read-only
        return torch.as_tensor(np.array(a), dtype=dtype).to(device)

    return DeviceCode(
        code=code,
        device=device,
        edge_row=t(lay.edge_row),
        edge_col=t(lay.edge_col),
        edge_shift=t(lay.edge_shift),
        row_ptr=t(lay.row_ptr),
        col_slots=t(lay.col_slots),
        col_mask=t(lay.col_mask, torch.bool),
        col_deg=t(lay.col_deg),
    )


def to_device(code: LdpcCode, device) -> DeviceCode:
    """The code's layout tables as tensors on `device` (cached per pair)."""
    return _to_device(code, resolve_device(device))
