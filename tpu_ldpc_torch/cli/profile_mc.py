"""`python -m tpu_ldpc_torch.cli.profile_mc` -- where the time of the
Monte-Carlo step goes on one CUDA device.

    python -m tpu_ldpc_torch.cli.profile_mc

For the judged (1024, 512) code, min-sum 50 iterations with early
termination, at 2.0 dB, batch 4096 and 8 batches per call (the step
``run_ber`` runs on the card), it prints:

- the card's name, power limit and largest SM clock (nvidia-smi);
- the wall time of 3 step calls untraced, then traced with
  torch.profiler, and the profiler's cost (traced / untraced wall);
- the device time per kernel (the trace's device events), its sum, the
  device span of the trace and two idle shares: of the traced span
  (profiler overhead included), and of the untraced wall (1 - device
  time / untraced wall, which assumes tracing leaves each kernel's own
  time unchanged);
- the decode kernel with early termination off against batch (CUDA
  events), with its shared-memory traffic against the peak of 32 banks x
  4 bytes per clock per SM (CUDA C++ Programming Guide, "Shared Memory")
  at the SM count and largest SM clock of the card.

Without a CUDA device it exits with 1.
"""

from __future__ import annotations

import sys
import time


def _smem_accesses_per_iteration(code, E: int) -> int:
    """4-byte shared-memory accesses of one codeword-iteration of
    csrc/bp_flood.cu (min-sum): CN pass 1 reads P and R, pass 2 reads P and R
    and writes R (5 per edge-check); the VN pass reads R (1 per edge) and
    reads L and writes P (2 per variable)."""
    return 6 * E * code.Z + 2 * code.n


BATCH, SPC, CALLS, EBN0_DB = 4096, 8, 3, 2.0
SCALING_BATCHES = (1024, 4096, 16384)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_mc: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from tpu_ldpc_torch import LdpcCode
    from tpu_ldpc_torch.benchcore import smi
    from tpu_ldpc_torch.codes_device import to_device
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder
    from tpu_ldpc_torch.sim.mc import DecodeCfg, build_mc_step

    print(f"nvidia-smi name,power.limit: {smi('name,power.limit')}")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    code = LdpcCode.judged()
    step = build_mc_step(code, DecodeCfg(), BATCH, SPC, device="cuda")

    for t in range(CALLS):  # warm-up, and the kernel build
        step(0, 0, EBN0_DB, SPC * t).tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(CALLS):
        step(0, 0, EBN0_DB, SPC * (t + CALLS)).tolist()
    wall_untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for t in range(CALLS):
            step(0, 0, EBN0_DB, SPC * (t + CALLS)).tolist()
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    batches = CALLS * SPC
    print(f"MC step judged b={BATCH} {EBN0_DB} dB spc={SPC}, "
          f"{CALLS} calls = {batches} batches: untraced wall "
          f"{wall_untraced * 1e3:.4f} ms ({wall_untraced * 1e3 / batches:.4f}"
          f" ms/batch), traced wall {wall_traced * 1e3:.4f} ms: profiler "
          f"cost {100 * (wall_traced / wall_untraced - 1):.1f}%")

    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel: dict[str, list] = {}
    for e in evs:
        tot = per_kernel.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.elapsed_us()
        tot[1] += 1
    busy_us = sum(us for us, _ in per_kernel.values())
    for name, (us, count) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us:12.1f} us {100 * us / busy_us:6.2f}% n={count:5d} "
              f"{name[:90]}")
    span_us = (max(e.time_range.end for e in evs)
               - min(e.time_range.start for e in evs))
    print(f"device time {busy_us:.1f} us in {len(evs)} device events "
          f"({len(evs) / batches:.1f} per batch); traced device span "
          f"{span_us:.1f} us: idle {100 * (1 - busy_us / span_us):.1f}% of "
          f"the traced span (profiler overhead included), "
          f"{100 * (1 - busy_us / (wall_untraced * 1e6)):.1f}% of the "
          f"untraced wall")

    E = to_device(code, "cuda").E
    k1 = build_cuda_decoder(code, "minsum", 50, 0.75, 0.0, early_stop=False)
    acc = _smem_accesses_per_iteration(code, E)
    peak_bps = 32 * 4 * sms * max_sm_mhz * 1e6
    for b in SCALING_BATCHES:
        gen = torch.Generator(device="cuda").manual_seed(b)
        llr = (torch.randn((b, code.n), generator=gen, device="cuda") * 2
               + 2).contiguous()
        for _ in range(2):
            k1(llr)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            k1(llr)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        smem_bps = 4 * acc * 50 * b / (ms * 1e-3)
        print(f"kernel ET off b={b}: {ms:.4f} ms, {ms / b * 1e3:.4f} "
              f"us/codeword, {b * code.k / ms / 1e6:.4f} Gb/s info; shared "
              f"memory {smem_bps / 1e12:.3f} TB/s of a {peak_bps / 1e12:.3f} "
              f"TB/s peak ({sms} SMs x {max_sm_mhz:.0f} MHz x 128 B)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
