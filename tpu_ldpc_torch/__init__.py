"""tpu_ldpc_torch: the PyTorch / CUDA port of tpu_ldpc for NVIDIA Hopper.

A second package beside ``tpu_ldpc``, which stays the reference.  It
imports ``torch`` and never ``jax``.  The framework-free parts of
``tpu_ldpc`` are reused, not copied: ``tpu_ldpc.codes`` (``LdpcCode``,
``TannerLayout``, the registry), ``tpu_ldpc.golden`` and
``tpu_ldpc.report.waterfall``.

Slice 1 covers the main path: the judged (1024, 512) code and the
registry's wifi / wimax families, BPSK over AWGN, normalized / offset
min-sum with the flooding schedule, early termination on or off:

- ``codes_device.to_device``: the code's tables as tensors on a device;
- ``channel``, ``encode``: plain PyTorch;
- ``decode.reference``: the plain PyTorch decoder (the CPU path);
- ``decode.cuda_bp`` + ``csrc/minsum_flood.cu``: the hand-written CUDA
  decode kernel for sm_90a;
- ``decode.api``, ``sim``, ``cli``: the public entry points.

Every function takes an explicit ``device`` (or follows its input
tensor's device) and every random draw an explicit ``torch.Generator``.
"""

__version__ = "0.1.0"

from tpu_ldpc.codes.code import LdpcCode  # noqa: F401
