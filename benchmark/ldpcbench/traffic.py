"""The benchmark's inputs, made from the seed on the device.

``llr_buffers`` is the decode-only traffic: ``n_buffers`` batches of
random info bits, encoded by the reference's systematic encoder, sent as
BPSK with unit-normal noise at the operating point, LLRs
``scale * (x + sig * noise)`` with ``sig**2 = noise_sigma2(ebn0, rate)``
and ``scale = 2 / sig**2`` (the program's throughput timer's generator,
``tpu_ldpc_torch/benchcore.py::make_timer``, copied).  Together the
buffers exceed the card's 50 MiB L2, so each decode reads its input from
device memory.

The Monte-Carlo and search traffic is the program's own draw rule (each
batch from (seed, snr_idx, batch_ctr), ``reference.batch_generator``);
``search_seed`` derives the seed of the i-th search of a run.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpcbench.reference import Code, noise_sigma2


def llr_buffers(code: Code, batch: int, ebn0_db: float, n_buffers: int,
                seed: int, device) -> list[torch.Tensor]:
    sigma2 = noise_sigma2(ebn0_db, code.k / code.n)
    scale, sig = 2.0 / sigma2, float(np.sqrt(sigma2))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = []
    for _ in range(int(n_buffers)):
        u = torch.randint(0, 2, (batch, code.k), generator=gen, device=device,
                          dtype=torch.uint8)
        x = 1.0 - 2.0 * code.encode(u).to(torch.float32)
        noise = torch.randn(x.shape, generator=gen, device=device,
                            dtype=torch.float32)
        out.append((scale * (x + sig * noise)).contiguous())
    return out


def search_seed(seed: int, i: int) -> int:
    """The seed of search i of a run seeded with `seed`."""
    return int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint32)[0])
