"""`python -m tpu_ldpc_torch.sim` -- alias for the sweep CLI."""

from tpu_ldpc_torch.cli.sim import main

main()
