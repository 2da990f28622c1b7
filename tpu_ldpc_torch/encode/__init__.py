"""Encoders: generator matrix product, dual-diagonal back-substitution and
the general pivot path (L1)."""

from tpu_ldpc_torch.encode.encoder import (  # noqa: F401
    build_encoder,
    encode,
    select_encoder,
)
