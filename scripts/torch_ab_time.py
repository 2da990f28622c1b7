"""Time the decode kernels of tpu_ldpc_torch -- every layered
instantiation (K2, K3, K4, K5, K7 and K9 layered), the compressed-state
kernel K6 and the flooding kernels (K1, K3, K4, K5, K7 min-sum, K8 and
the normalized K1) -- in several copies of the repository on one card,
in turns, for A/B comparisons of commits in one run.

    mkdir -p build/ab/base
    git archive <base commit> tpu_ldpc_torch | tar -x -C build/ab/base
    python scripts/torch_ab_time.py build/ab/base . . build/ab/base

Each argument is a directory holding a ``tpu_ldpc_torch`` package with
``decode.cuda_bp.build_cuda_decoder``.  First every copy builds its
kernels into its own ``build/``, all copies at once; then each is timed
in a process of its own, in the order given, so base, change, change,
base puts both under the same card state.  Judged (1024, 512) code,
batch 4096, flooding at 50 and layered at 25 iterations, in the code's
own coordinates but K9 (normalized), K5 at 6 bits, step 0.25; ET off,
and ET on ("ET") for the layered kernels and K6 on the same LLRs (noisy all-zero
codewords at 2.0 dB: with ET off the time does not depend on them); five
rounds of 20 launches each between CUDA events.  Prints the card's name
and power limit, one JSON line per copy: {"tree": ..., kernel: [median
ms, [the five rounds]]}, and a table of the medians.
"""

import json
import os
import subprocess
import sys

BATCH = 4096
ROUNDS = 5
REPS = 20
Q6 = {"quant_bits": 6, "quant_step": 0.25}
# name: (algo, schedule, iterations, build_cuda_decoder keywords, ET)
KERNELS = {
    "K2 minsum_layered": ("minsum", "layered", 25, {}, False),
    "K3 sumproduct_layered": ("sumproduct", "layered", 25, {}, False),
    "K4 spfast_layered": ("sumproduct-fast", "layered", 25, {}, False),
    "K5 minsum_quant_layered": ("minsum", "layered", 25, Q6, False),
    "K7 minsum_layered_bf16": ("minsum", "layered", 25,
                               {"msg_dtype": "bf16"}, False),
    "K7 sumproduct_layered_bf16": ("sumproduct", "layered", 25,
                                   {"msg_dtype": "bf16"}, False),
    "K7 spfast_layered_bf16": ("sumproduct-fast", "layered", 25,
                               {"msg_dtype": "bf16"}, False),
    "K9 minsum_layered_normalized": ("minsum", "layered", 25,
                                     {"normalize": True}, False),
    "K2 minsum_layered ET": ("minsum", "layered", 25, {}, True),
    "K3 sumproduct_layered ET": ("sumproduct", "layered", 25, {}, True),
    "K4 spfast_layered ET": ("sumproduct-fast", "layered", 25, {}, True),
    "K5 minsum_quant_layered ET": ("minsum", "layered", 25, Q6, True),
    "K7 minsum_layered_bf16 ET": ("minsum", "layered", 25,
                                  {"msg_dtype": "bf16"}, True),
    "K6 minsum_compressed_flood": ("minsum", "flooding", 50,
                                   {"compressed": True}, False),
    "K6 minsum_compressed_flood ET": ("minsum", "flooding", 50,
                                      {"compressed": True}, True),
    "K1 minsum_flood": ("minsum", "flooding", 50, {}, False),
    "K3 sumproduct_flood": ("sumproduct", "flooding", 50, {}, False),
    "K4 spfast_flood": ("sumproduct-fast", "flooding", 50, {}, False),
    "K5 minsum_quant_flood": ("minsum", "flooding", 50, Q6, False),
    "K7 minsum_flood_bf16": ("minsum", "flooding", 50, {"msg_dtype": "bf16"},
                             False),
    "K8 minsum_rescaled_flood": ("minsum", "flooding", 50, {"rescaled": True},
                                 False),
    "K9 minsum_flood_normalized": ("minsum", "flooding", 50,
                                   {"normalize": True}, False),
}


def _build_tree(tree: str) -> None:
    """Runs inside a child process: build the copy's kernels."""
    sys.path.insert(0, tree)
    from tpu_ldpc_torch import _build

    _build.load_all()


def _time_tree(tree: str) -> dict:
    """Runs inside a child process: time the copy under `tree`."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from tpu_ldpc_torch import LdpcCode, _build
    from tpu_ldpc_torch.decode.cuda_bp import build_cuda_decoder

    if not torch.cuda.is_available():
        raise RuntimeError("torch_ab_time needs a CUDA device")
    _build.load_all()
    code = LdpcCode.judged()
    # all-zero codewords at 2.0 dB
    sigma2 = 1.0 / (2 * code.rate * 10 ** 0.2)
    rng = np.random.default_rng(1)
    llr = torch.from_numpy((2.0 / sigma2 * (
        1.0 + np.sqrt(sigma2) * rng.normal(size=(BATCH, code.n))))
        .astype(np.float32)).cuda()
    fns = {}
    for name, (algo, sched, iters, kw, et) in KERNELS.items():
        kw = {"normalize": False, **kw}
        if kw.get("msg_dtype") == "bf16":
            kw["msg_dtype"] = torch.bfloat16
        fns[name] = build_cuda_decoder(code, algo, iters, 0.75, 0.0, sched,
                                       et, **kw)

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
    if argv[:1] == ["--build"]:
        _build_tree(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    here = os.path.abspath(__file__)
    trees = [os.path.abspath(tree) for tree in argv]
    builds = {tree: subprocess.Popen(
        [sys.executable, here, "--build", tree], cwd=tree,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree in dict.fromkeys(trees)}
    for tree, proc in builds.items():
        out = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"{tree}: build failed\n{out[-4000:]}")
    medians = []
    for tree in trees:
        # the child imports tpu_ldpc_torch from `tree` alone
        out = subprocess.run(
            [sys.executable, here, "--one", tree], capture_output=True,
            text=True, timeout=600, cwd=tree)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        medians.append(json.loads(line))
    print("median ms | " + " | ".join(argv))
    for name in KERNELS:
        print(f"{name} | " + " | ".join(f"{row[name][0]:.4f}"
                                         for row in medians))
    return 0


if __name__ == "__main__":
    sys.exit(main())
