"""The port's host side against the JAX package's: graphs, block stores,
tiles and schedules array for array, the int32 device layout, the
interop round trip, and the rule that the port imports neither jax
nor ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.algorithms import bfs_algorithm as r_bfs
from repro.algorithms import pagerank_algorithm as r_pagerank
from repro.algorithms import tc_algorithm as r_tc
from repro.kernels import registry as r_registry

import repro_torch.core as tc
from repro_torch import interop
from repro_torch.algorithms import bfs_algorithm, pagerank_algorithm, tc_algorithm
from repro_torch.kernels import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (name, generator args) — the four generators, small
GRAPHS = {
    "rmat": ("rmat", (9, 8), dict(seed=3)),
    "er": ("erdos_renyi", (400, 6.0), dict(seed=2)),
    "road": ("grid_road", (16,), {}),
    "star": ("star_skew", (512,), dict(hubs=3, seed=1)),
}


def _graphs(name, *, ordered=False):
    fn, args, kw = GRAPHS[name]
    gr, gt = getattr(rc, fn)(*args, **kw), getattr(tc, fn)(*args, **kw)
    if ordered:
        gr, _ = rc.degree_order(gr, ascending=False)
        gt, _ = tc.degree_order(gt, ascending=False)
    return gr, gt


STORE_ARRAYS = ("src", "dst", "edge_block", "block_ptr", "indptr", "indices",
                "row_block_ptr", "tile_block_ids", "tiles", "tile_row_start",
                "tile_col_start")


def _assert_store_equal(sr, st):
    for k in STORE_ARRAYS:
        a, b = np.asarray(getattr(sr, k)), getattr(st, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("cuts", "block_ids", "block_edge_counts", "grid_pos"):
        np.testing.assert_array_equal(getattr(sr.layout, k), getattr(st.layout, k),
                                      err_msg=k)
    assert sr.tile_dim == st.tile_dim


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("ordered", [False, True])
def test_graph_generators_match(name, ordered):
    gr, gt = _graphs(name, ordered=ordered)
    assert (gr.n, gr.directed, gr.name) == (gt.n, gt.directed, gt.name)
    np.testing.assert_array_equal(gr.indptr, gt.indptr)
    np.testing.assert_array_equal(gr.indices, gt.indices)


ALGS = {
    "pagerank": (r_pagerank, pagerank_algorithm, {}),
    "bfs": (r_bfs, bfs_algorithm, {}),
    "tc": (r_tc, tc_algorithm, {}),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("alg", sorted(ALGS))
@pytest.mark.parametrize("p,mode", [(4, "hybrid"), (8, "hybrid"), (4, "dense_only")])
def test_store_and_schedule_match(name, alg, p, mode):
    gr, gt = _graphs(name, ordered=True)
    if alg == "tc":
        from repro.algorithms.tc import orient_dag as r_orient
        from repro_torch.algorithms.tc import orient_dag as t_orient

        gr, gt = r_orient(gr), t_orient(gt)
    sr, st = rc.build_block_store(gr, p), tc.build_block_store(gt, p)
    mk_r, mk_t, _ = ALGS[alg]
    kw = dict(tile_dim=128, dense_density=0.001, mode=mode, num_devices=2)
    qr = rc.build_schedule(mk_r(), sr, **kw)
    qt = tc.build_schedule(mk_t(), st, **kw)
    _assert_store_equal(sr, st)
    for k in ("blocklists", "weights", "order", "dense_task_mask",
              "dense_block_ids", "device_assignment"):
        a, b = getattr(qr, k), getattr(qt, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (qr.tile_dim, qr.num_devices) == (qt.tile_dim, qt.num_devices)
    assert qr.stats == qt.stats


def test_schedule_has_dense_tasks_on_a_degree_ordered_graph():
    # the sweep above must exercise the tile path, not only the edge path
    _, gt = _graphs("rmat", ordered=True)
    q = tc.build_schedule(pagerank_algorithm(), tc.build_block_store(gt, 4),
                          tile_dim=128, dense_density=0.001)
    assert 0 < q.stats["dense_tasks"] < q.num_tasks


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_to_device_narrows_to_int32(name):
    _, gt = _graphs(name, ordered=True)
    st = tc.build_block_store(gt, 4)
    tc.build_schedule(pagerank_algorithm(), st, tile_dim=128, dense_density=0.001)
    arrays = st.to_device("cpu")
    for k in ("src", "dst", "edge_block", "indptr", "indices", "degrees",
              "row_block_ptr", "cuts", "tile_row_start", "tile_col_start"):
        assert arrays[k].dtype == torch.int32, k
        np.testing.assert_array_equal(arrays[k].numpy(),
                                      getattr(st, k, None) if k != "cuts"
                                      else st.layout.cuts, err_msg=k)
    assert arrays["tiles"].dtype == torch.float32
    assert st.to_device("cpu") is arrays          # built once per device


def test_to_device_raises_when_a_value_does_not_fit_int32():
    _, gt = _graphs("road")
    st = tc.build_block_store(gt, 4)
    st.indptr = st.indptr + np.int64(2**31)
    with pytest.raises(OverflowError, match="indptr"):
        st.to_device("cpu")


def test_build_block_store_rejects_sort_key_overflow():
    g = tc.Graph(indptr=np.zeros(2**21 + 1, np.int64), indices=np.zeros(0, np.int32),
                 n=2**21)
    with pytest.raises(OverflowError, match="p²·n²"):
        tc.build_block_store(g, 2**11)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_interop_store_round_trip(name):
    gr, _ = _graphs(name, ordered=True)
    sr = rc.build_block_store(gr, 4)
    rc.build_schedule(r_pagerank(), sr, tile_dim=128, dense_density=0.001)
    fields = {k: getattr(sr, k) for k in interop.STORE_FIELDS if k != "cuts"}
    fields.update({k: getattr(sr, k) for k in interop.TILE_FIELDS},
                  cuts=sr.layout.cuts)
    st = interop.store_from_numpy(fields, directed=gr.directed, name=gr.name)
    _assert_store_equal(sr, st)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("alg", ["pagerank", "tc"])
def test_tile_extents_are_the_blocks_ranges(name, alg):
    gr, gt = _graphs(name, ordered=True)
    if alg == "tc":
        from repro.algorithms.tc import orient_dag as r_orient
        from repro_torch.algorithms.tc import orient_dag as t_orient

        gr, gt = r_orient(gr), t_orient(gt)
    sr, st = rc.build_block_store(gr, 8), tc.build_block_store(gt, 8)
    mk_r, mk_t, _ = ALGS[alg]
    rc.build_schedule(mk_r(), sr, tile_dim=128, dense_density=0.001)
    tc.build_schedule(mk_t(), st, tile_dim=128, dense_density=0.001)
    assert st.tile_block_ids.size > 0
    want = np.array([sr.block_range(int(b)) for b in sr.tile_block_ids], np.int32)
    assert st.tile_rows.dtype == st.tile_cols.dtype == np.int32
    np.testing.assert_array_equal(np.stack([st.tile_rows, st.tile_cols], 1), want)
    for tile, rows, cols in zip(st.tiles, st.tile_rows, st.tile_cols):
        assert not tile[rows:].any() and not tile[:, cols:].any()
    arrays = st.to_device("cpu")
    for k in ("tile_rows", "tile_cols"):
        assert arrays[k].dtype == torch.int32
        np.testing.assert_array_equal(arrays[k].numpy(), getattr(st, k))
    # a store carried across from the reference's fields gets the same extents
    fields = {k: getattr(sr, k) for k in interop.STORE_FIELDS if k != "cuts"}
    fields.update({k: getattr(sr, k) for k in interop.TILE_FIELDS}, cuts=sr.layout.cuts)
    carried = interop.store_from_numpy(fields, directed=gr.directed, name=gr.name)
    np.testing.assert_array_equal(carried.tile_rows, st.tile_rows)
    np.testing.assert_array_equal(carried.tile_cols, st.tile_cols)


def test_interop_state_keeps_dtypes():
    state = interop.state_from_numpy(
        dict(a=np.arange(3, dtype=np.int32), b=np.float32(2.5), c=np.zeros(2, bool)),
        "cpu")
    assert [state[k].dtype for k in "abc"] == [torch.int32, torch.float32, torch.bool]
    assert state["b"].shape == ()


@pytest.mark.parametrize("kernel", ["spmv_tiles", "frontier_tiles", "tc_tiles"])
@pytest.mark.parametrize("nd,tile_dim,devices", [(1, 128, 1), (37, 512, 1), (37, 512, 4)])
def test_workspace_estimators_match(kernel, nd, tile_dim, devices):
    hints = dict(nd=nd, tile_dim=tile_dim, devices=devices)
    assert registry.workspace_bytes(kernel, **hints) == \
        r_registry.workspace_bytes(kernel, **hints)
    assert registry.max_workspace_bytes(**hints) == r_registry.max_workspace_bytes(**hints)
    assert set(registry.registered_workspaces()) == set(r_registry.registered_workspaces())


def _py_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: p.name)
def test_port_source_imports_neither_jax_nor_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for nm in names:
            assert nm.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, nm)


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_compile_plan_without_device_raises_on_a_cardless_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, gt = _graphs("road")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.compile_plan(pagerank_algorithm(), tc.build_block_store(gt, 4))
