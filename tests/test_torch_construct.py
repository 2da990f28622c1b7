"""Code construction in the port (codes/anneal.py, peg.py, pexit.py and
the construction half of base_graphs.py) against the JAX package's on the
same inputs: the same seeds give the same tables, stats, thresholds and
masks, exactly."""

import os

import numpy as np
import pytest

from tpu_ldpc.codes import anneal as jax_anneal
from tpu_ldpc.codes import base_graphs as jax_bg
from tpu_ldpc.codes import peg as jax_peg
from tpu_ldpc.codes import pexit as jax_pexit
from tpu_ldpc.codes.code import LdpcCode as JaxLdpcCode
from tpu_ldpc_torch.codes import LdpcCode, anneal, peg, pexit
from tpu_ldpc_torch.codes import base_graphs as bg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_zeroed():
    """tests/test_aux.py's anneal toy: a 4x8 Z=8 base with every info
    shift set to 0 (many 4-cycles)."""
    B = jax_bg.make_base_graph(4, 8, 8, seed=3).copy()
    B[:, :4][B[:, :4] >= 0] = 0
    return B, 8


ANNEAL_CASES = {
    # name: (base, Z, kwargs)
    "toy_zeroed": (*toy_zeroed(), dict(steps=400, seed=1)),
    "c4_c6_wifi34": (np.asarray(JaxLdpcCode.from_family("wifi", "3/4", 27).B),
                     27, dict(steps=150, seed=4)),
    "ace": (jax_bg.make_base_graph(6, 12, 12, seed=2), 12,
            dict(steps=250, seed=5, ace=True, w4=1e6)),
    "w8_counts": (jax_bg.make_base_graph(4, 8, 16, seed=1), 16,
                  dict(steps=120, seed=6, w8=0.01)),
    "w8_ace": (jax_bg.make_base_graph(4, 8, 16, seed=1), 16,
               dict(steps=120, seed=6, w4=1e6, w6=1000.0, w8=1.0, ace=True,
                    t0=0.1, t1=0.003)),
    "frozen_cols": (*toy_zeroed(), dict(steps=200, seed=2,
                                        frozen_cols=[0, 5, 6, 7])),
    "all_frozen": (*toy_zeroed(), dict(steps=50, frozen_cols=list(range(8)))),
}


@pytest.mark.parametrize("case", sorted(ANNEAL_CASES))
def test_anneal_equals_jax(case):
    B, Z, kw = ANNEAL_CASES[case]
    got, stats = anneal.anneal_shifts(B, Z, **kw)
    want, want_stats = jax_anneal.anneal_shifts(B, Z, **kw)
    assert np.array_equal(got, want)
    assert stats == want_stats  # key for key, floats exactly
    assert stats.keys() == want_stats.keys()
    frozen = kw.get("frozen_cols", range(B.shape[1] - B.shape[0],
                                         B.shape[1]))
    assert np.array_equal(got[:, list(frozen)], B[:, list(frozen)])


def test_anneal_removes_cycles():
    """tests/test_aux.py's toy: fewer 4-cycles, parity part untouched."""
    B, Z = toy_zeroed()
    z0 = bg.count_4cycles(B, Z)
    B2, stats = anneal.anneal_shifts(B, Z, steps=400, seed=1)
    assert 0 <= stats["c4"] < z0
    assert np.array_equal(B2[:, 4:], B[:, 4:])


@pytest.mark.parametrize("col_order", ["weight", "index", "random"])
def test_peg_assign_equals_jax(col_order):
    B = jax_bg.make_base_graph(4, 8, 8, seed=7)
    got = peg.peg_assign_shifts(B, 8, seed=3, col_order=col_order)
    want = jax_peg.peg_assign_shifts(B, 8, seed=3, col_order=col_order)
    assert np.array_equal(got, want)
    assert np.array_equal(got >= 0, B >= 0)
    dc, pc = peg._bfs_check_dists(got, 8, 1)
    wdc, wpc = jax_peg._bfs_check_dists(got, 8, 1)
    assert np.array_equal(dc, wdc) and np.array_equal(pc, wpc)


def test_peg_candidate_equals_jax():
    B = np.asarray(JaxLdpcCode.from_family("wimax", "5/6", 24).B)
    got, stats = peg.peg_candidate(B, 24, seed=1, polish_steps=40)
    want, want_stats = jax_peg.peg_candidate(B, 24, seed=1, polish_steps=40)
    assert np.array_equal(got, want)
    assert stats == want_stats
    assert stats["c4"] == 0


def test_j_functions_equal_jax():
    sigma = np.linspace(0.0, 12.0, 241)
    assert np.array_equal(pexit.J(sigma), jax_pexit.J(sigma))
    mi = np.linspace(0.0, 1.0, 201)
    assert np.array_equal(pexit.J_inv(mi), jax_pexit.J_inv(mi))
    np.testing.assert_allclose(pexit.J(pexit.J_inv(mi[1:-1])), mi[1:-1],
                               rtol=0, atol=1e-9)


def test_pexit_thresholds_equal_jax():
    judged = JaxLdpcCode.judged().B >= 0
    grid = np.arange(0.0, 2.0, 0.1)
    assert np.array_equal(pexit.pexit_converges(judged, grid),
                          jax_pexit.pexit_converges(judged, grid))
    assert (pexit.pexit_converges(judged, 1.5)
            == jax_pexit.pexit_converges(judged, 1.5))
    for mask, kw in (
            (judged, {}),
            (judged, dict(step=0.02)),
            (JaxLdpcCode.from_family("wifi", "5/6", 27).B >= 0,
             dict(step=0.02)),
            (np.ones((3, 6), bool), dict(lo=0.5, hi=2.0, step=0.05))):
        assert pexit.pexit_threshold(mask, **kw) == \
            jax_pexit.pexit_threshold(mask, **kw)


def test_sc_threshold_saturation_equals_jax():
    """tests/test_pexit.py's SC case: the coupled chain beats the
    uncoupled (3,6) ensemble, and the longer chain the shorter one."""
    ths = []
    for L in (32, 8):
        mask = bg.make_sc_base_graph(L, 16, seed=9) >= 0
        assert np.array_equal(mask,
                              jax_bg.make_sc_base_graph(L, 16, seed=9) >= 0)
        th = pexit.pexit_threshold(mask, step=0.05, lo=0.2, hi=1.6)
        assert th == jax_pexit.pexit_threshold(mask, step=0.05, lo=0.2,
                                               hi=1.6)
        ths.append(th)
    assert ths[0] < 1.0 and ths[0] < ths[1]


@pytest.mark.parametrize("mb,nb,kw", [
    (3, 6, dict(seed=0, steps=15)),
    (4, 8, dict(seed=3, steps=40, threshold_kwargs=dict(
        lo=0.2, hi=2.0, step=0.1, max_iters=200))),
    (3, 6, dict(seed=1, steps=25, col_w_min=2, row_w_max=8)),
])
def test_search_mask_and_build_equal_jax(mb, nb, kw):
    mask, stats = pexit.search_mask(mb, nb, **kw)
    want, want_stats = jax_pexit.search_mask(mb, nb, **kw)
    assert np.array_equal(mask, want)
    assert stats == want_stats
    got_pm, got_frozen = pexit.parity_mask(mb, nb)
    want_pm, want_frozen = jax_pexit.parity_mask(mb, nb)
    assert np.array_equal(got_pm, want_pm)
    assert np.array_equal(got_frozen, want_frozen)
    for Z in (8, 13):
        assert np.array_equal(bg.build_from_mask(mask, Z, seed=2),
                              jax_bg.build_from_mask(mask, Z, seed=2))


def test_search_mask_from_init_and_refusals():
    init = np.ones((4, 8), bool)
    got = pexit.search_mask(4, 8, seed=2, steps=10, init_mask=init)
    want = jax_pexit.search_mask(4, 8, seed=2, steps=10, init_mask=init)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    with pytest.raises(ValueError):
        pexit.search_mask(4, 4)
    with pytest.raises(ValueError):
        pexit.search_mask(4, 8, init_mask=np.ones((3, 8), bool))
    bad = pexit.parity_mask(4, 8)[0]
    bad[3, 5] = True  # not the canonical parity part
    with pytest.raises(ValueError, match="canonical"):
        bg.build_from_mask(bad, 8)


@pytest.mark.parametrize("family,rate,Z,seed,profile", [
    ("wimax", "5/6", 12, 5, "legacy"),
    ("wimax", "5/6", 16, 5, "pexit"),
])
def test_generate_family_cell_equals_jax(family, rate, Z, seed, profile):
    got = bg.generate_family_cell(family, rate, Z, seed, profile=profile)
    want = jax_bg.generate_family_cell(family, rate, Z, seed,
                                       profile=profile)
    assert np.array_equal(got, want)
    if profile == "pexit":  # a mask is taken once it lifts 4-cycle-free
        assert bg.count_4cycles(got, Z) == 0


def test_family_base_graph_generates_uncommitted_cell(monkeypatch):
    """A (family, rate, Z) with no committed table is generated from its
    cell seed, as in the JAX package (which both registries are extended
    to offer here)."""
    cell = ("wifi", "5/6", 12)
    for mod in (bg, jax_bg):
        monkeypatch.setitem(mod.FAMILY_LIFTS, "wifi", (12, 27, 54, 81))
    assert not os.path.exists(os.path.join(bg._DATA_DIR, "wifi_r56_z12.qc"))
    got = bg.family_base_graph(*cell)
    assert np.array_equal(got, jax_bg.family_base_graph(*cell))
    code = LdpcCode.from_family(*cell)
    assert code.name == "wifi_r56_z12" and code.n == 24 * 12
    assert np.array_equal(code.B, got)
    with pytest.raises(ValueError, match="supports Z"):
        bg.family_base_graph("wifi", "5/6", 13)


def test_profiles_json_is_a_byte_copy():
    with open(os.path.join(REPO, "tpu_ldpc", "codes", "data",
                           "profiles.json"), "rb") as f:
        want = f.read()
    with open(os.path.join(bg._DATA_DIR, "profiles.json"), "rb") as f:
        assert f.read() == want
    assert bg._load_profiles() == jax_bg._load_profiles()
