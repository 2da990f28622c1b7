"""Decoders: plain PyTorch min-sum / sum-product / sumproduct-fast /
fixed-point min-sum on the flooding and layered schedules, with shift
normalization, rescaled min-sum, bf16 messages or compressed row state,
the CUDA kernels, the hard-decision (bitflip, WBF) and windowed SC-LDPC
decoders (L2)."""

from tpu_ldpc_torch.decode.api import build_decode_fn, decode  # noqa: F401
