"""Decoders: plain PyTorch flooding min-sum + the CUDA kernel (L2)."""

from tpu_ldpc_torch.decode.api import build_decode_fn, decode  # noqa: F401
