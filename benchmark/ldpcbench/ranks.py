"""The ranks of a cell that asks for more than one card.

Rank 0 is the process that runs the cell (``run.py``, ``control.py`` or
a test); it starts ranks 1 .. N-1 as processes of the harness, one card
each (rank r on cuda:r; on the CPU every rank on the CPU).  Each rank
gets the environment torchrun gives (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR 127.0.0.1, MASTER_PORT and
TORCHELASTIC_USE_AGENT_STORE), so the program's
``dist/mesh.py::init_distributed`` joins the group through env://, NCCL
on cards and gloo on the CPU (``join``).  As under torchrun, the
rendezvous store is the launcher's: rank 0 opens it on a port the system
picks before any rank starts, and every rank connects to it.  (A port
picked, closed and bound again later can be taken in between, by a
rank's own retrying connection among others.)

Failures: the group has a timeout (``GROUP_TIMEOUT_S``).  A thread of
rank 0 watches the other ranks: as soon as one exits with another code
than 0 it ends the rest and the whole process (exit code 3, no line).
The other ranks end with rank 0 (the parent-death signal, on Linux), and
at the close rank 0 joins them against ``JOIN_S``.  So no rank outlives
the run.
"""

from __future__ import annotations

import ctypes
import datetime
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

GROUP_TIMEOUT_S = 300  # a cold checkout builds the kernels on every rank
JOIN_S = 60
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_USE_AGENT_STORE")
_BOOT = ("import json, sys; spec = json.loads(sys.argv[1]); "
         "sys.path[:0] = spec['path']; "
         "from ldpcbench.ranks import worker_main; "
         "sys.exit(worker_main(spec))")


def rank_env(rank: int, world: int, port: int) -> dict:
    r, n = str(rank), str(world)
    return {"RANK": r, "WORLD_SIZE": n, "LOCAL_RANK": r,
            "LOCAL_WORLD_SIZE": n, "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "TORCHELASTIC_USE_AGENT_STORE": "True"}


def join(device_type: str) -> None:
    """Join the group of this rank's environment through the program."""
    from tpu_ldpc_torch.dist.mesh import init_distributed

    init_distributed(device=device_type, timeout=datetime.timedelta(
        seconds=GROUP_TIMEOUT_S))


def leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class Ranks:
    """``with Ranks(world, call, kwargs):`` the block runs as rank 0, in
    this process and its environment; ranks 1 .. world-1 run
    ``call(**kwargs)`` (a "module:function" name) as processes of the
    harness, each returning its exit code.  A clean close waits for them
    all and raises unless each exited with 0."""

    def __init__(self, world: int, call: str, kwargs: dict):
        self.world, self.call, self.kwargs = int(world), call, kwargs
        self.procs: list[subprocess.Popen] = []
        self.store = None
        self._saved: dict = {}
        self._closing = threading.Event()
        self._lock = threading.Lock()

    def __enter__(self):
        import torch.distributed as dist

        # the rendezvous store, on a port the system picks
        self.store = dist.TCPStore(
            "127.0.0.1", 0, self.world, is_master=True,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
            wait_for_workers=False)
        port = self.store.port
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = [p for p in (here, *sys.path) if p]
        for rank in range(1, self.world):
            spec = {"path": path, "call": self.call, "kwargs": self.kwargs,
                    "parent": os.getpid()}
            env = dict(os.environ, **rank_env(rank, self.world, port))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _BOOT, json.dumps(spec)], env=env,
                stdin=subprocess.DEVNULL, stdout=2))
        self._saved = {k: os.environ.get(k) for k in _ENV}
        os.environ.update(rank_env(0, self.world, port))
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def _watch(self):
        while not self._closing.wait(0.1):
            with self._lock:
                if self._closing.is_set():
                    return
                for rank, p in enumerate(self.procs, 1):
                    rc = p.poll()
                    if rc not in (None, 0):
                        self._kill()
                        print(f"benchmark: rank {rank} exited with {rc}; "
                              "the run ends", file=sys.stderr, flush=True)
                        os._exit(3)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def __exit__(self, exc_type, exc, tb):
        with self._lock:
            self._closing.set()
        try:
            if exc_type is None:
                deadline = time.monotonic() + JOIN_S
                for rank, p in enumerate(self.procs, 1):
                    try:
                        rc = p.wait(max(0.0, deadline - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        raise RuntimeError(
                            f"rank {rank} did not end within {JOIN_S} s "
                            "of rank 0") from None
                    if rc != 0:
                        raise RuntimeError(f"rank {rank} exited with {rc}")
        finally:
            self._kill()
            for k, v in self._saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            leave()
            self.store = None
        return False


def _die_with_parent(parent: int) -> None:
    """Have the kernel end this process when its parent ends (Linux's
    PR_SET_PDEATHSIG; elsewhere the group's timeout ends it)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:  # the parent ended before the prctl
        os._exit(3)


def worker_main(spec: dict) -> int:
    _die_with_parent(int(spec["parent"]))
    module, name = spec["call"].split(":")
    return getattr(importlib.import_module(module), name)(**spec["kwargs"])
