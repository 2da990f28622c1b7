"""Channel models and LLR computation (L3): BPSK over AWGN."""

from tpu_ldpc_torch.channel.awgn import (  # noqa: F401
    awgn_llrs,
    bpsk,
    llrs_from_noise,
    noise_sigma2,
)
