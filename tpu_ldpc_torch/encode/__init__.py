"""Encoders: generator matrix product and general pivot path (L1)."""

from tpu_ldpc_torch.encode.encoder import (  # noqa: F401
    build_encoder,
    select_encoder,
)
