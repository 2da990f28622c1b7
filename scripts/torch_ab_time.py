"""Time the flooding and layered min-sum kernels (K1, K2) of
tpu_ldpc_torch in several copies of the repository on one card, in turns,
for A/B comparisons of two commits in one run.

    mkdir -p build/ab/base
    git archive <base commit> tpu_ldpc_torch | tar -x -C build/ab/base
    python scripts/torch_ab_time.py build/ab/base . . build/ab/base

Each argument is a directory holding a ``tpu_ldpc_torch`` package with
``decode.cuda_bp.build_cuda_decoder``; each is timed in a process of its
own (which builds that copy's kernels into its own ``build/``), in the
order given, so base, change, change, base puts both under the same card
state.  Judged (1024, 512) code, batch 4096, ET off, K1 at 50 and K2 at
25 iterations, in plain coordinates (K1, K2) and normalized (K1n, K2n);
five rounds of 20 launches each between CUDA events.  Prints the card's
name and power limit, then one JSON line per copy: {kernel: [median ms,
[the five rounds]]}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

BATCH = 4096
ROUNDS = 5
REPS = 20


def _time_tree(tree: str) -> dict:
    """Runs inside the child process: time the copy under `tree`."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tpu_ldpc_torch import LdpcCode, _build
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

    if not torch.cuda.is_available():
        raise RuntimeError("torch_ab_time needs a CUDA device")
    _build.load_all()
    code = LdpcCode.judged()
    # all-zero codeword at 2.0 dB: with ET off the time does not depend on
    # the LLRs' values
    sigma2 = 1.0 / (2 * code.rate * 10 ** 0.2)
    rng = np.random.default_rng(1)
    llr = torch.from_numpy((2.0 / sigma2 * (
        1.0 + np.sqrt(sigma2) * rng.normal(size=(BATCH, code.n))))
        .astype(np.float32)).cuda()
    fns = {}
    for norm, tag in ((False, ""), (True, "n")):
        for name, iters, sched in (("K1", 50, "flooding"),
                                   ("K2", 25, "layered")):
            fns[name + tag] = build_cuda_decoder(
                code, "minsum", iters, 0.75, 0.0, sched, False,
                normalize=norm)

    def ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn(llr)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    for fn in fns.values():
        fn(llr)
    torch.cuda.synchronize()
    runs = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            runs[name].append(ms(fn))
    return {name: [float(np.median(v)), v] for name, v in runs.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps({"tree": argv[1], **_time_tree(argv[1])}))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    for tree in argv:
        # the child imports tpu_ldpc_torch from `tree` alone
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(tree)], capture_output=True, text=True,
            timeout=600, cwd=os.path.abspath(tree))
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
