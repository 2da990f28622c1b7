"""The port's own code layer (tpu_ldpc_torch.codes) vs the JAX package's.

The port keeps its own NumPy copies of the code construction; every code
the port decodes must be the JAX package's code bit for bit: the same
base matrix B, Tanner layout arrays, lifted H and generator parity map.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from tpu_ldpc.codes import LdpcCode as JaxLdpcCode
from tpu_ldpc.codes import base_graphs as jax_base_graphs
from tpu_ldpc.codes.alist import load_alist as jax_load_alist
from tpu_ldpc.golden.encoder import gf2_inv as jax_gf2_inv
from tpu_ldpc.golden.encoder import gf2_row_reduce as jax_gf2_row_reduce
from tpu_ldpc.report import waterfall as jax_waterfall
from tpu_ldpc_torch.codes import LdpcCode, base_graphs
from tpu_ldpc_torch.codes.alist import (
    load_alist, load_shift_table, save_alist, save_shift_table)
from tpu_ldpc_torch.codes.gf2 import gf2_inv, gf2_row_reduce
from tpu_ldpc_torch.report import waterfall

REGISTRY = [(family, rate, Z)
            for family, lifts in sorted(base_graphs.FAMILY_LIFTS.items())
            for rate in sorted(base_graphs._RATE_SHAPES)
            for Z in lifts]
LAYOUT_FIELDS = ("edge_row", "edge_col", "edge_shift", "row_ptr",
                 "col_slots", "col_mask", "row_deg", "col_deg")


def assert_same_code(port, ref, parity=True):
    assert port.name == ref.name and port.Z == ref.Z
    np.testing.assert_array_equal(port.B, ref.B)
    assert (port.n, port.k, port.m) == (ref.n, ref.k, ref.m)
    for field in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(port.layout, field),
                                      getattr(ref.layout, field),
                                      err_msg=field)
    assert port.layout.E == ref.layout.E
    assert (port.H != sp.csr_matrix(ref.H)).nnz == 0
    if parity:
        np.testing.assert_array_equal(port.parity_M, ref.parity_M)


def test_registry_has_24_cells_with_tables():
    assert len(REGISTRY) == 24


@pytest.mark.parametrize("family,rate,Z", REGISTRY,
                         ids=[f"{f}_{r.replace('/', '')}_z{z}"
                              for f, r, z in REGISTRY])
def test_registry_cell_equals_jax(family, rate, Z):
    port = LdpcCode.from_family(family, rate, Z)
    ref = JaxLdpcCode.from_family(family, rate, Z)
    assert_same_code(port, ref)


def test_judged_code_equals_jax():
    assert_same_code(LdpcCode.judged(), JaxLdpcCode.judged())
    np.testing.assert_array_equal(base_graphs.judged_base_graph(),
                                  jax_base_graphs.judged_base_graph())


def test_toy_code_equals_jax():
    B = base_graphs.make_base_graph(4, 8, 8, seed=7)
    np.testing.assert_array_equal(
        B, jax_base_graphs.make_base_graph(4, 8, 8, seed=7))
    assert_same_code(LdpcCode.from_base_graph(B, 8, "toy8"),
                     JaxLdpcCode.from_base_graph(B, 8, "toy8"))


def test_sc_chain_equals_jax():
    B = base_graphs.make_sc_base_graph(8, 16)
    np.testing.assert_array_equal(B, jax_base_graphs.make_sc_base_graph(8, 16))
    port = LdpcCode.from_base_graph(B, 16, "sc_l8_z16")
    ref = JaxLdpcCode.from_base_graph(B, 16, "sc_l8_z16")
    assert_same_code(port, ref, parity=False)  # rank-deficient: no map
    with pytest.raises(ValueError, match="singular"):
        port.parity_M
    Hd = np.asarray(port.H.todense())
    rref, piv = gf2_row_reduce(Hd)
    want_rref, want_piv = jax_gf2_row_reduce(Hd)
    np.testing.assert_array_equal(rref, want_rref)
    assert piv == want_piv


def test_from_base_graph_carries_a_jax_code_across():
    ref = JaxLdpcCode.from_family("wimax", "5/6", 96)
    port = LdpcCode.from_base_graph(np.asarray(ref.B), ref.Z, ref.name)
    assert port == LdpcCode.from_family("wimax", "5/6", 96)
    assert hash(port) == hash(LdpcCode.from_family("wimax", "5/6", 96))
    assert_same_code(port, ref, parity=False)


def test_girth_and_gf2_inverse_equal_jax():
    code = LdpcCode.from_family("wifi", "5/6", 27)
    ref = JaxLdpcCode.from_family("wifi", "5/6", 27)
    assert code.girth_lower_bound() == ref.girth_lower_bound()
    for cnt, jcnt in ((base_graphs.count_4cycles, jax_base_graphs._count_4cycles_py),
                      (base_graphs.count_6cycles, jax_base_graphs._count_6cycles_py)):
        assert cnt(code.B, 27) == jcnt(ref.B, 27)
    M = np.random.default_rng(3).integers(0, 2, (12, 12)).astype(np.uint8)
    M[np.arange(12), np.arange(12)] = 1
    M = np.triu(M)  # unit upper triangular: invertible
    np.testing.assert_array_equal(gf2_inv(M), jax_gf2_inv(M))
    assert not ((gf2_inv(M).astype(int) @ M) % 2 - np.eye(12)).any()


def test_family_errors():
    with pytest.raises(ValueError, match="unknown family"):
        base_graphs.family_base_graph("nr", "1/2", 64)
    with pytest.raises(ValueError, match="supports Z"):
        base_graphs.family_base_graph("wifi", "1/2", 64)


def test_shift_table_round_trip(tmp_path):
    code = LdpcCode.from_family("wifi", "3/4", 54)
    path = str(tmp_path / "c.qc")
    save_shift_table(code, path)
    back = load_shift_table(path, name=code.name)
    assert back == code
    assert load_shift_table(path).name == "c.qc"


def test_alist_round_trip_and_jax_reader(tmp_path):
    code = LdpcCode.from_base_graph(
        base_graphs.make_base_graph(4, 8, 8, seed=7), 8, "toy8")
    path = str(tmp_path / "toy.alist")
    save_alist(code.H, path)
    back = load_alist(path, Z=8, name="toy8")
    assert back == code
    assert (load_alist(path).H != code.H).nnz == 0  # Z auto-detected
    ref = jax_load_alist(path, Z=8, name="toy8")
    np.testing.assert_array_equal(back.B, ref.B)


def test_waterfall_report_equals_jax():
    class R:
        ebn0_db, frames, bit_errors, frame_errors = 2.0, 65536, 900, 700
        detected, undetected, iter_sum, wall_s = 690, 10, 800000, 1.25
        fer, ber, mean_iters = 700 / 65536, 900 / (65536 * 512), 12.2

    assert waterfall.wilson_interval(700, 65536) == \
        jax_waterfall.wilson_interval(700, 65536)
    assert waterfall.wilson_interval(0, 0) == (0.0, 1.0)
    assert waterfall.waterfall_csv([R]) == jax_waterfall.waterfall_csv([R])
    assert waterfall.waterfall_table([R]) == jax_waterfall.waterfall_table([R])
    rows = waterfall.load_csv(waterfall.waterfall_csv([R]))
    assert rows == jax_waterfall.load_csv(jax_waterfall.waterfall_csv([R]))
    assert rows[0]["frames"] == 65536
