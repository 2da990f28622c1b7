"""Channel models and LLR computation (L3): BPSK over AWGN, rate
adaptation (puncturing and shortening), the binary symmetric channel."""

from tpu_ldpc_torch.channel.awgn import (  # noqa: F401
    awgn_llrs,
    bpsk,
    llrs_from_noise,
    noise_sigma2,
)
from tpu_ldpc_torch.channel.adapt import (  # noqa: F401
    RateAdapt,
    adapted_awgn_llrs,
    adapted_llrs_from_noise,
)
from tpu_ldpc_torch.channel.bsc import (  # noqa: F401
    bsc_llr_magnitude,
    bsc_llrs,
    bsc_llrs_from_flips,
)
