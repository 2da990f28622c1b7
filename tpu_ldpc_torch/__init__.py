"""tpu_ldpc_torch: the PyTorch / CUDA port of tpu_ldpc for NVIDIA Hopper.

A second package beside ``tpu_ldpc``, which stays the reference.  It
imports ``torch`` and never ``jax``, and nothing of ``tpu_ldpc``: what it
needs of the JAX package's framework-free modules it keeps as its own
copies, under the same names (``codes/``, ``report/``).

Slices 1-3 cover BPSK over AWGN on the judged (1024, 512) code, the
registry's wifi / wimax families, alist and SC codes, decoded with
normalized / offset min-sum, exact sum-product, sumproduct-fast or
fixed-point min-sum, on the flooding or the layered schedule, early
termination on or off, and the search for the Eb/N0 at a target FER.
Slice 4 adds the JAX Pallas builder's modes: shift normalization,
rescaled min-sum, bf16 message storage and the compressed row state.
Slices 5-6 redesigned the flooding and layered kernel bodies for the
H100.  Slice 7 adds the rate-compatible transmission path: the
dual-diagonal encoder, the NR-like BG1/BG2 families, puncturing and
shortening, the BSC, an outer CRC that gates the counters, and IR-HARQ.
Slice 8 adds the hard-decision and windowed decoders; slice 9 code
construction and analysis (annealing, PEG, PEXIT, d_min bounds, the
trapping-set census, the construction CLI); slice 10 distribution over
ranks (the sharded MC step, the grid-sharded sweep, the partitioned and
ring decoders, the torchrun launcher); slice 11 the throughput benchmark
CLI and its timer, the MC step's fault-injection hook and ``encode()``:

- ``codes``: LdpcCode, the registry, the Tanner layout, GF(2) algebra,
  construction and analysis (host NumPy);
- ``_native``: the host helper for construction (cycle counters,
  bit-packed GF(2)), C++ built with g++ at first use;
- ``codes_device.to_device``: the code's tables as tensors on a device;
- ``channel`` (AWGN, ``RateAdapt``, BSC), ``encode``, ``codes.crc``:
  plain PyTorch;
- ``decode.reference``: the plain PyTorch decoder (the CPU path);
- ``decode.normalize``: the shift-normalization offsets;
- ``decode.cuda_bp`` (``build_cuda_decoder``) + ``csrc/bp_flood.cu``,
  ``csrc/bp_layered.cu``, ``csrc/bp_compressed.cu``: the hand-written
  CUDA decode kernels for sm_90a;
- ``decode.api``, ``sim`` (``run_ber``, ``find_ebn0_at_fer``,
  ``harq.run_irharq``), ``cli`` (``cli.bench``: throughput), ``report``:
  the public entry points;
- ``benchcore``: the card's throughput timer (CUDA events);
- ``spans``: ``span(name)``, the torch.profiler annotations at each layer
  boundary (``ldpc.search``, ``ldpc.mc.*``, ``ldpc.decode``,
  ``ldpc.build``), a shared no-op while no profiler runs;
- ``dist``: process groups (``init_distributed``, ``make_mesh``), the
  sharded MC step, the grid sweep, the partitioned and ring decoders.

Every function takes an explicit ``device`` (or follows its input
tensor's device) and every random draw on the device an explicit
``torch.Generator``; construction and the census draw on the host with
NumPy's ``default_rng``, as the JAX package does, so their results
match it.
"""

__version__ = "0.7.0"

from tpu_ldpc_torch.codes.code import LdpcCode  # noqa: F401
from tpu_ldpc_torch.dist import (  # noqa: F401
    build_sharded_mc_step,
    fold_generator_rank,
    init_distributed,
    make_mesh,
    run_ber_sharded,
)
