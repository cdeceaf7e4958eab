"""The port's Shiloach–Vishkin, Afforest, k-core and HITS on the CPU
against the JAX package's ``backend="xla"`` runs, on one store carried
across with ``repro_torch.interop``.

Tolerances: component labels, k-core membership, iteration counts and
direction decisions are integers and bools and must be identical.  HITS
sums float32 contributions in another order than XLA's segment sum, so
hubs and authorities agree to rtol 1e-5 / atol 1e-8 (as PageRank); the
iteration counts are equal when both run a fixed number of iterations.
"""
import numpy as np
import pytest

import repro.core as rc
from repro.algorithms import afforest_algorithm as r_afforest
from repro.algorithms import hits_algorithm as r_hits
from repro.algorithms import kcore_algorithm as r_kcore
from repro.algorithms import sv_algorithm as r_sv

from repro_torch import obs
from repro_torch.algorithms import (
    afforest_algorithm, connected_components, hits, hits_algorithm, k_core,
    kcore_algorithm, shiloach_vishkin, sv_algorithm,
)
from repro_torch.core import build_block_store, compile_plan, rmat

from test_torch_algorithms import GRAPHS, _carry

EXACT = {
    "sv": (r_sv, sv_algorithm, {}),
    "afforest": (r_afforest, afforest_algorithm, {}),
    "kcore3": (lambda: r_kcore(3), lambda: kcore_algorithm(3), dict(mode="sparse_only")),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("alg", sorted(EXACT))
@pytest.mark.parametrize("direction", ["push", "pull", "auto"])
def test_exact_algorithms_match_reference_bit_for_bit(name, alg, direction):
    r_alg, p_alg, kw = EXACT[alg]
    sr = rc.build_block_store(GRAPHS[name](), 4)
    want = rc.compile_plan(r_alg(), sr, backend="xla", direction=direction, **kw).run()
    got = compile_plan(p_alg(), _carry(sr), device="cpu", direction=direction, **kw).run()
    assert got.iterations == want.iterations, \
        f"iterations: port {got.iterations}, reference {want.iterations}"
    np.testing.assert_array_equal(got.result, np.asarray(want.result))
    d_got, d_want = got.schedule_stats["direction"], want.schedule_stats["direction"]
    assert d_got["decisions"] == d_want["decisions"]
    assert d_got["switches"] == d_want["switches"]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("tol", [-1.0, 1e-8])
def test_hits_matches_reference(name, tol):
    # a negative tol never stops early: both run max_iters.  At the default tol=1e-8 the stopping
    # test compares a float32 L1 delta at its noise floor, so the two
    # summation orders may stop a few iterations apart (ROADMAP C); both
    # have converged then, and the vectors must still agree
    sr = rc.build_block_store(GRAPHS[name](), 4)
    want = rc.compile_plan(r_hits(tol=tol, max_iters=40), sr, backend="xla",
                           mode="sparse_only").run()
    got = compile_plan(hits_algorithm(tol=tol, max_iters=40), _carry(sr), device="cpu",
                       mode="sparse_only").run()
    if tol < 0:
        assert got.iterations == want.iterations == 80
    for k in ("hub", "auth"):
        np.testing.assert_allclose(got.result[k], np.asarray(want.result[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def _components(labels):
    """Labels → a canonical partition (each vertex's first vertex)."""
    _, first = np.unique(labels, return_index=True)
    order = np.argsort(first)
    return np.searchsorted(np.sort(first), first)[np.argsort(order)][
        np.unique(labels, return_inverse=True)[1]]


def test_convenience_wrappers_agree():
    store = build_block_store(rmat(8, 8, seed=3), 4)
    sv = shiloach_vishkin(store, device="cpu")
    cc = connected_components(store, device="cpu")
    np.testing.assert_array_equal(_components(sv), _components(cc))
    core = k_core(store, 3, device="cpu")
    assert core.dtype == np.bool_ and core.shape == (store.n,)
    h = hits(store, device="cpu")
    assert abs(float(np.linalg.norm(h["hub"])) - 1.0) < 1e-4


def test_pointer_jumping_reads_one_flag_per_round():
    store = build_block_store(rmat(8, 8, seed=3), 4)
    rounds = obs.metrics.counter("pointer_jump.rounds")
    before = rounds.value
    res = compile_plan(sv_algorithm(), store, device="cpu").run()
    links = res.iterations // 2
    # every link reads at least the flag that ends it
    assert rounds.value - before >= links > 0
