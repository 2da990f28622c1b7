"""The port's distribution (tpu_ldpc_torch/dist) against the JAX package's
(tpu_ldpc/dist) on the CPU.

Ranks are spawned processes on a gloo group over 127.0.0.1
(tests/torch_dist_worker.py); one launch per world size (2 and 4) computes
every distributed result, while this process runs the JAX package on
conftest's 8 fake devices on the same NumPy-made inputs:

- the ring decoder equals JAX's build_ring_decoder bit for bit for
  min-sum (bits, ok, iters_used) and within its >= 0.95 frame contract
  for exact sum-product; its refusals carry JAX's messages;
- the partitioned decoder is syndrome-valid, agrees with JAX's and the
  port's plain decoder on >= 0.95 of frames (its all_reduce sums the
  ranks' posteriors in the backend's order) and is bit for bit the same
  between runs and ranks;
- the sharded step's counters equal the replay of every rank's
  fold_generator_rank streams through BatchFn exactly, the grid sweep's
  points the single-device batches they were issued, world 1 run_ber;
- the host loops (run_ber_sharded, run_ber_grid) equal JAX's field for
  field with both step builders replaced by the same stub;
- build_decode_fn(mesh=...) routes as JAX's does, by the flooding
  kernel's shared memory in place of the TPU's VMEM budget.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.golden import syndrome_ok
from tpu_ldpc_torch import LdpcCode
from tpu_ldpc_torch.codes import make_base_graph
from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph
from tpu_ldpc_torch.dist.mesh import Mesh, fold_generator_rank
from tpu_ldpc_torch.encode.encoder import select_encoder
from tpu_ldpc_torch.sim.mc import (
    COUNTER_FIELDS, BatchFn, DecodeCfg, batch_generator, build_mc_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
CPU = torch.device("cpu")


def toy_code():
    return LdpcCode.from_base_graph(make_base_graph(4, 8, 4, seed=7), 4,
                                    "toy")


def jax_twin(code):
    return JaxLdpcCode.from_base_graph(np.asarray(code.B), code.Z, code.name)


def banded_w3():
    """test_dist.py::test_ring_generalized_bandwidth's banded QC base
    (coupling width 3, three block-columns a position)."""
    rng = np.random.default_rng(11)
    mb, width, cols_per = 16, 3, 3
    nb = mb * cols_per // 2
    B = np.full((mb, nb), -1, dtype=np.int64)
    for i in range(mb):
        hi = min(((i * nb) // mb) + 1, nb - 1)
        lo = max(hi - (width * cols_per - 1) // 2, 0)
        for j in range(lo, hi + 1):
            if rng.random() < 0.8:
                B[i, j] = rng.integers(0, 8)
        if (B[i] >= 0).sum() < 2:
            B[i, max(hi - 1, 0)] = rng.integers(0, 8)
            B[i, hi] = rng.integers(0, 8)
    return B


def noisy_llrs(code, batch, ebn0, seed):
    """LLRs of random codewords (the port's encoder, on the CPU)."""
    enc, k, _ = select_encoder(code, device="cpu")
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, k)).astype(np.uint8)
    c = enc(torch.from_numpy(u)).numpy().astype(np.float64)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (ebn0 / 10))
    y = (1.0 - 2.0 * c) + np.sqrt(sigma2) * rng.normal(size=c.shape)
    return (2.0 / sigma2 * y).astype(np.float32)


def fake_mesh(size):
    """A mesh of `size` ranks seen from rank 0, with no process group:
    enough to build (not run) the decoders and to drive stubbed steps."""
    return Mesh(None, 0, size, CPU, CPU)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """One gloo group of `world` spawned ranks (torchrun's variables)."""

    def __init__(self, world, inputs, out_dir):
        self.world, self.out_dir = world, out_dir
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, inputs, out_dir],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(world)]
        self._ranks = None

    def ranks(self):
        """Every rank's pickled results (waits for the group once)."""
        if self._ranks is None:
            for p in self.procs:
                try:
                    out, err = p.communicate(timeout=240)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    pytest.fail(f"world {self.world}: a rank timed out")
                if p.returncode != 0:
                    for q in self.procs:
                        q.kill()
                    pytest.fail(f"world {self.world}: rank failed rc="
                                f"{p.returncode}\n{err.decode()[-3000:]}")
            self._ranks = []
            for r in range(self.world):
                with open(os.path.join(self.out_dir, f"rank{r}.pkl"),
                          "rb") as f:
                    self._ranks.append(pickle.load(f))
        return self._ranks


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both groups start at once, as the module starts."""
    tmp = tmp_path_factory.mktemp("dist")
    sc8 = LdpcCode.from_base_graph(make_sc_base_graph(8, 8, seed=5), 8, "sc8")
    w3 = LdpcCode(name="banded-w3", B=banded_w3(), Z=8)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, B_w3=w3.B, llr_sc8=noisy_llrs(sc8, 24, 4.0, 33),
             llr_w3=noisy_llrs(w3, 16, 4.5, 5),
             llr_toy=noisy_llrs(toy_code(), 24, 4.0, 21))
    out = {}
    for world in (2, 4):
        os.makedirs(tmp / f"w{world}")
        out[world] = Launch(world, inputs, str(tmp / f"w{world}"))
    data = dict(np.load(inputs))
    yield types.SimpleNamespace(
        launch=out, inputs=data, sc8=sc8, w3=w3,
        ranks=lambda world: out[world].ranks())
    for launch in out.values():
        for p in launch.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def replicated(ranks, key):
    """The value of `key`, asserted equal on every rank."""
    first = ranks[0][key]
    for r in ranks[1:]:
        assert _same(r[key], first), (key, r["rank"])
    return first


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def counters(row):
    return [row[f] for f in COUNTER_FIELDS]


# ---- the sharded MC step and host loop -------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_equals_rank_replay(launches, world):
    """One call, 2 batches a rank: the all-reduced counters are the same
    on every rank and equal the sum of every rank's streams replayed
    through BatchFn in this process, exactly."""
    ranks = launches.ranks(world)
    assert [r["mesh"] for r in ranks] == [(r, world) for r in range(world)]
    got = replicated(ranks, "step")
    fn = BatchFn(toy_code(), DecodeCfg(iters=20), 16, "cpu")
    want = sum(fn(fold_generator_rank(3, 1, ctr, rank, "cpu"), 4.0)
               for ctr in (2, 3) for rank in range(world))
    assert got == want.tolist()
    assert got[0] == 16 * 2 * world


@pytest.mark.parametrize("world", [2, 4])
def test_run_ber_sharded_equals_replay(launches, world):
    """run_ber(mesh=...) stops on the replicated counters (every rank the
    same results) after whole calls; each point's counters are the
    replay of the calls it made."""
    res = replicated(launches.ranks(world), "run_ber")
    fn = BatchFn(toy_code(), DecodeCfg(iters=20), 16, "cpu")
    for snr_idx, (ebn0, r) in enumerate(zip((3.0, 6.0), res)):
        calls = r["frames"] // (16 * world)
        assert r["frames"] == calls * 16 * world
        assert r["frame_errors"] >= 8 or r["frames"] >= 512
        want = sum(fn(fold_generator_rank(5, snr_idx, c, rank, "cpu"), ebn0)
                   for c in range(calls) for rank in range(world))
        assert counters(r) == want.tolist(), snr_idx
        assert r["bits"] == r["frames"] * fn.k
    assert res[0]["frame_errors"] / res[0]["frames"] >= (
        res[1]["frame_errors"] / res[1]["frames"])


def test_run_ber_refuses_another_card(monkeypatch):
    """run_ber(mesh=..., device='cuda:1') on a rank that computes on
    cuda:0 raises; 'cuda' names the rank's own card."""
    from tpu_ldpc_torch.sim.mc import run_ber

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    card0 = torch.device("cuda", 0)
    mesh = Mesh(None, 0, 1, card0, card0)
    with pytest.raises(ValueError, match="mesh computes on cuda:0"):
        run_ber(toy_code(), [3.0], mesh=mesh, device="cuda:1")
    with pytest.raises(ValueError, match="mesh computes on cuda:0"):
        run_ber(toy_code(), [3.0], mesh=mesh, device="cpu")


def test_sub_mesh_equals_run_ber(launches):
    """A sub-mesh of rank 0 alone (dist.new_group([0])) draws the
    single-device streams: run_ber over it equals run_ber with no mesh."""
    from tpu_ldpc_torch.sim.mc import run_ber

    got = launches.ranks(2)[0]["sub_run_ber"]
    want = run_ber(toy_code(), [3.0], DecodeCfg(iters=20), batch=16,
                   target_frame_errors=8, max_frames=256, seed=5,
                   device="cpu")
    assert got == port_result(want)


@pytest.mark.parametrize("world", [2, 4])
def test_grid_points_equal_single_device_batches(launches, world):
    """Each point of the grid sweep equals the sum of the single-device
    batches (batch_generator, no rank folded) whose ctrs it issued."""
    res = replicated(launches.ranks(world), "grid")
    step = build_mc_step(toy_code(), DecodeCfg(iters=15), 16, 1,
                         device="cpu")
    for p, (ebn0, r) in enumerate(zip((2.0, 5.0, 8.0), res)):
        assert r["frame_errors"] >= 6 or r["frames"] >= 256
        want = sum(step(4, p, ebn0, ctr) for ctr in range(r["frames"] // 16))
        assert counters(r) == want.tolist(), p


def test_fold_generator_rank_zero_is_the_single_device_stream():
    for seed, snr_idx, ctr in ((0, 0, 0), (3, 1, 2), (20261016, 4, 1023)):
        one = batch_generator(seed, snr_idx, ctr, "cpu")
        zero = fold_generator_rank(seed, snr_idx, ctr, 0, "cpu")
        other = fold_generator_rank(seed, snr_idx, ctr, 1, "cpu")
        a, b, c = (torch.randn(64, generator=g) for g in (one, zero, other))
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_workers_import_no_jax(launches):
    for world in (2, 4):
        assert all(r["jax_loaded"] == [] for r in launches.ranks(world))


# ---- the host loops against JAX's, on a stub step --------------------------


def stub_row(seed, p, ctr, rank, batch=16, fers=(0.6, 0.08, 0.01)):
    """Deterministic counters of one (point, ctr, rank) batch."""
    rng = np.random.default_rng([seed, p, ctr, rank])
    fe = int(rng.binomial(batch, fers[p]))
    det = int(rng.integers(0, fe + 1))
    return [batch, 3 * fe + int(rng.integers(0, 2)), fe, det, fe - det,
            batch * 4 + fe]


def port_result(res):
    return [{k: v for k, v in dataclasses.asdict(r).items() if k != "wall_s"}
            for r in res]


@pytest.mark.parametrize("ranks,target,max_frames", [
    (4, 6, 512), (3, 40, 4096), (1, 5, 64)])
def test_grid_scheduler_matches_jax(monkeypatch, ranks, target, max_frames):
    import tpu_ldpc.dist.grid as jax_grid
    import tpu_ldpc_torch.dist.grid as port_grid

    def jax_builder(code, cfg, batch, mesh, axis="mc"):
        def step(seed, snr_idx, ebn0, ctrs):
            return np.array([stub_row(int(seed[0]), int(p), int(c), 0)
                             for p, c in zip(np.asarray(snr_idx),
                                             np.asarray(ctrs))])
        return step

    def port_builder(code, cfg, batch, mesh):
        def step(seed, snr_idx, ebn0, ctrs):
            return torch.tensor([stub_row(seed, p, c, 0)
                                 for p, c in zip(snr_idx, ctrs)])
        step.k = 512
        return step

    monkeypatch.setattr(jax_grid, "build_grid_mc_step", jax_builder)
    monkeypatch.setattr(port_grid, "build_grid_mc_step", port_builder)
    kw = dict(batch=16, target_frame_errors=target, max_frames=max_frames,
              seed=9)
    grid = [1.0, 2.0, 3.0]
    want = jax_grid.run_ber_grid(
        types.SimpleNamespace(k=512), grid, None,
        mesh=types.SimpleNamespace(shape={"mc": ranks}), **kw)
    got = port_grid.run_ber_grid(None, grid, None, mesh=fake_mesh(ranks),
                                 **kw)
    assert port_result(got) == port_result(want)
    assert sum(r.frames for r in got) % (16 * ranks) == 0


@pytest.mark.parametrize("ranks,spc", [(4, 1), (2, 3)])
def test_sharded_host_loop_matches_jax(monkeypatch, ranks, spc):
    import tpu_ldpc.dist.mesh as jax_mesh
    import tpu_ldpc_torch.dist.mesh as port_mesh

    def total(seed, p, ctr0):
        return np.sum([stub_row(seed, p, ctr0 + t, r) for t in range(spc)
                       for r in range(ranks)], axis=0)

    def jax_builder(*args, **kw):
        def step(seed, snr_idx, ebn0, ctr0):
            return total(int(seed[0]), int(snr_idx[0]), int(ctr0[0]))
        step.k = 500
        return step

    def port_builder(*args, **kw):
        def step(seed, snr_idx, ebn0, ctr0):
            return torch.from_numpy(total(seed, snr_idx, ctr0))
        step.k = 500
        return step

    monkeypatch.setattr(jax_mesh, "build_sharded_mc_step", jax_builder)
    monkeypatch.setattr(port_mesh, "build_sharded_mc_step", port_builder)
    kw = dict(batch=16, target_frame_errors=20, max_frames=2000, seed=2,
              steps_per_call=spc)
    grid = [1.0, 2.0, 3.0]
    want = jax_mesh.run_ber_sharded(
        types.SimpleNamespace(k=500), grid, None,
        mesh=types.SimpleNamespace(size=ranks), **kw)
    got = port_mesh.run_ber_sharded(None, grid, None, mesh=fake_mesh(ranks),
                                    **kw)
    assert port_result(got) == port_result(want)


# ---- the ring and partitioned decoders --------------------------------------


@pytest.fixture(scope="module")
def jax_mesh4():
    from tpu_ldpc.dist.mesh import make_mesh

    return {axis: make_mesh(jax.devices()[:4], axis=axis)
            for axis in ("code", "tp")}


@pytest.mark.parametrize("case", ["sc8", "w3"])
def test_ring_minsum_bit_exact_with_jax(launches, jax_mesh4, case):
    from tpu_ldpc.dist.ring import build_ring_decoder

    code = getattr(launches, case)
    iters = 20 if case == "sc8" else 15
    llr = launches.inputs[f"llr_{case}"]
    got = replicated(launches.ranks(4), f"ring_{case}_minsum")
    want = build_ring_decoder(jax_twin(code), jax_mesh4["code"],
                              iters=iters)(llr)
    for g, w, what in zip(got, want, ("bits", "ok", "iters_used")):
        assert np.array_equal(g, np.asarray(w)), what
    assert syndrome_ok(jax_twin(code).H, got[0])[got[1]].all()
    assert got[1].mean() > 0.5


def test_ring_sumproduct_within_jax_contract(launches, jax_mesh4):
    from tpu_ldpc.dist.ring import build_ring_decoder

    code = jax_twin(launches.sc8)
    bits, ok, iu = replicated(launches.ranks(4), "ring_sc8_sumproduct")
    jb, jok, jiu = map(np.asarray, build_ring_decoder(
        code, jax_mesh4["code"], algo="sumproduct", iters=20)(
            launches.inputs["llr_sc8"]))
    assert syndrome_ok(code.H, bits)[ok].all()
    assert (bits == jb).all(axis=1).mean() >= 0.95
    assert (ok == jok).mean() >= 0.95


@pytest.mark.parametrize("case", ["toy", "sc6", "sc9", "sc10"])
def test_ring_refusals_match_jax(jax_mesh4, case):
    """The same ValueError, message and all, as JAX's ring on 4 devices;
    sc10 (position boundaries not rank-aligned) is accepted by both."""
    from tpu_ldpc.dist.ring import build_ring_decoder as jax_ring
    from tpu_ldpc_torch.dist.ring import build_ring_decoder, fits_ring

    code = (toy_code() if case == "toy" else LdpcCode.from_base_graph(
        make_sc_base_graph(int(case[2:]), 8, seed=1), 8, case))
    mesh = fake_mesh(4)
    if case == "sc10":
        jax_ring(jax_twin(code), jax_mesh4["code"])
        build_ring_decoder(code, mesh)
        assert fits_ring(code, 4)
        return
    with pytest.raises(ValueError) as want:
        jax_ring(jax_twin(code), jax_mesh4["code"])
    with pytest.raises(ValueError) as got:
        build_ring_decoder(code, mesh)
    assert str(got.value) == str(want.value)
    assert not fits_ring(code, 4)


def test_partitioned_toy(launches, jax_mesh4):
    """Syndrome-valid, >= 0.95 of frames with JAX's partitioned decoder
    and the port's plain one, and bit for bit between runs and ranks."""
    from tpu_ldpc.dist.partitioned import build_partitioned_decoder
    from tpu_ldpc_torch.decode.reference import build_decoder

    code, llr = toy_code(), launches.inputs["llr_toy"]
    first, second = replicated(launches.ranks(4), "partitioned_toy")
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    bits, ok, iu = first
    assert syndrome_ok(jax_twin(code).H, bits)[ok].all()
    jb, jok, _ = map(np.asarray, build_partitioned_decoder(
        jax_twin(code), jax_mesh4["tp"], iters=20)(llr))
    pb, pok, _ = (x.numpy() for x in build_decoder(code, "minsum", 20)(
        torch.from_numpy(llr)))
    for wb, wok in ((jb, jok), (pb, pok)):
        assert (bits == wb).all(axis=1).mean() >= 0.95
        assert (ok == wok).mean() >= 0.95


def test_partitioned_refuses_more_ranks_than_block_rows():
    from tpu_ldpc_torch.dist.partitioned import build_partitioned_decoder

    with pytest.raises(ValueError, match="block rows"):
        build_partitioned_decoder(toy_code(), fake_mesh(8))  # mb=4
    build_partitioned_decoder(toy_code(), fake_mesh(4))


# ---- routing ------------------------------------------------------------


def sc_code(L, Z=64):
    return LdpcCode.from_base_graph(make_sc_base_graph(L, Z), Z,
                                    f"sc_l{L}_z{Z}")


def test_flood_smem_bytes():
    """The host copy of ldpc_bp_flood_smem_bytes on the judged code (bucket
    8) and the SC chains at Z=64: 3072 B a position plus bucket 0's
    tables (76 B a position), so L=73 is the longest chain one block
    holds."""
    from tpu_ldpc_torch.decode.flood_plan import (
        SMEM_LIMIT_BYTES, code_flood_smem_bytes, flood_smem_bytes)

    judged = LdpcCode.judged()
    assert code_flood_smem_bytes(judged) == 3 * 1024 * 4 + 51 * 64 * 4
    assert flood_smem_bytes(64, 8, 16, 51, 8, True) == 3 * 1024 * 4 + 51 * 128
    for L in (32, 73, 74, 128):
        E = 6 * L
        want = 3072 * L + (L + 3 + 3 * E) * 4
        assert code_flood_smem_bytes(sc_code(L)) == want
        assert (want <= SMEM_LIMIT_BYTES) == (L <= 73)


@pytest.mark.parametrize("case", ["ring", "partitioned", "world1", "kernel"])
def test_routing(case):
    """JAX's routing test on 8 ranks: a code whose flooding state exceeds
    one block's shared memory goes to the ring decoder when banded
    (sc_l128_z64) and to the partitioned decoder otherwise (the 12x24
    Z=512 code); sc-l32-z64, which the JAX package routes for its VMEM
    budget, fits the H100's kernel and is not routed."""
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.dist.partitioned import build_partitioned_decoder
    from tpu_ldpc_torch.dist.ring import (
        build_ring_decoder, fits_ring, is_banded)

    mesh = fake_mesh(8)
    cfg = DecodeCfg(algo="minsum", iters=6)
    kw = dict(algo="minsum", iters=6, alpha=cfg.alpha, beta=cfg.beta)
    if case == "ring":
        code = sc_code(128)
        assert build_decode_fn(code, cfg, "cpu", mesh=mesh) is (
            build_ring_decoder(code, mesh, **kw))
    elif case == "partitioned":
        code = LdpcCode.from_base_graph(make_base_graph(12, 24, 512, seed=3),
                                        512, "huge-nonbanded")
        with pytest.raises(ValueError, match="band width"):
            build_ring_decoder(code, mesh, **kw)
        assert build_decode_fn(code, cfg, "cpu", mesh=mesh) is (
            build_partitioned_decoder(code, mesh, **kw))
    elif case == "world1":
        # one rank: the ring could take any code; the band test keeps the
        # dense base on the partitioned decoder
        one = fake_mesh(1)
        code = LdpcCode.from_base_graph(make_base_graph(12, 24, 512, seed=3),
                                        512, "huge-nonbanded")
        assert fits_ring(code, 1) and not is_banded(code)
        assert build_decode_fn(code, cfg, "cpu", mesh=one) is (
            build_partitioned_decoder(code, one, **kw))
        big = sc_code(128)
        assert is_banded(big) and build_decode_fn(
            big, cfg, "cpu", mesh=one) is build_ring_decoder(big, one, **kw)
    else:
        code = sc_code(32)
        fn = build_decode_fn(code, cfg, "cpu", mesh=mesh)
        assert fn is not build_ring_decoder(code, mesh, **kw)
        # layered, quantized or impl='torch' decodes are never routed
        big = sc_code(128)
        for other in (DecodeCfg(iters=6, schedule="layered"),
                      DecodeCfg(iters=6, quant_bits=6),
                      DecodeCfg(iters=6, impl="torch")):
            assert build_decode_fn(big, other, "cpu", mesh=mesh) is not (
                build_ring_decoder(big, mesh, **kw))


# ---- world 1 in this process (a HashStore group, no torchrun) ------------


@pytest.fixture()
def world1(monkeypatch):
    import torch.distributed as dist

    from tpu_ldpc_torch.dist.mesh import init_distributed

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    init_distributed(device="cpu")
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_world_one_run_ber_and_resume(world1, tmp_path):
    """Without torchrun init_distributed makes a group of one (a second
    call is a no-op); run_ber over its mesh equals run_ber with no mesh
    field for field, and a checkpointed sweep resumes to the same
    totals."""
    from tpu_ldpc_torch.dist.mesh import init_distributed, make_mesh
    from tpu_ldpc_torch.sim.mc import run_ber
    from tpu_ldpc_torch.sim.state import SweepState

    init_distributed(device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.comm_device) == (
        0, 1, CPU, CPU)
    assert world1.get_backend() == "gloo"
    kw = dict(cfg=DecodeCfg(iters=20), batch=16, target_frame_errors=10,
              max_frames=256, seed=5, device="cpu")
    want = port_result(run_ber(toy_code(), [2.5, 4.0], **kw))
    assert port_result(run_ber(toy_code(), [2.5, 4.0], mesh=mesh,
                               **kw)) == want
    path = str(tmp_path / "ck.json")
    # a first run stopped early (3 calls), then resumed to the target
    run_ber(toy_code(), [2.5, 4.0], mesh=mesh, state=SweepState(path),
            **dict(kw, max_frames=48))
    resumed = run_ber(toy_code(), [2.5, 4.0], mesh=mesh,
                      state=SweepState(path), **kw)
    assert port_result(resumed) == want


def test_world_one_routed_ring_decodes(world1):
    """The routed ring decoder at world 1 on sc_l128_z64 (n = 16384):
    high-SNR all-zero frames converge, as in JAX's routing test."""
    from tpu_ldpc_torch.decode.api import build_decode_fn
    from tpu_ldpc_torch.dist.mesh import make_mesh

    code = sc_code(128)
    rng = np.random.default_rng(5)
    sigma2 = 1.0 / (2 * code.rate * 10 ** (5.0 / 10))
    llr = torch.from_numpy(((2.0 / sigma2) * (1.0 + np.sqrt(sigma2) * rng.normal(
        size=(2, code.n)))).astype(np.float32))
    fn = build_decode_fn(code, DecodeCfg(iters=6), "cpu",
                         mesh=make_mesh(device="cpu"))
    bits, ok, iu = fn(llr)
    assert ok.all() and not bits.any() and (iu <= 6).all()
