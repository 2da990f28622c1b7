"""The tpu_ldpc_torch benchmark's own code: harness, plain reference,
traffic generator, roofline arithmetic and trace reduction."""
