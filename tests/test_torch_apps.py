"""The port's graph apps (PageRank, SSSP, BFS) against the JAX package's on
the CPU: the cases of tests/test_apps.py and tests/test_masked.py:81-101.

Both packages build each app from the same matrix; the JAX apps run in
interpret mode, the port's with ``device="cpu"`` (the plain versions of
the kernels).  Tolerances:

  * PageRank within 1e-5, max|d| / max|ref|, of the JAX ``PageRank`` (the
    order of fp32 sums in the SpMV, and the port's fold against the JAX
    combine tree), and within the JAX
    tests' rtol=2e-3 of ``pagerank_reference``;
  * SSSP distances and ``iters_run`` equal to the JAX ``SSSP``'s (min_plus
    rounds once per term and takes exact minima), and within the JAX
    tests' rtol=1e-4 of Dijkstra with the same vertices unreachable;
  * BFS levels equal to the JAX ``BFS``'s and to scipy's unweighted
    shortest-path levels;
  * masked runs equal to the dense runs and to the JAX masked runs;
  * the apps' packs, and the combine trees the port's ``build_combine``
    makes of them, byte-equal to the JAX package's;
  * the apps' fold into rank order against the port's combine tree on the
    same y: min_plus and max_times (after ``> 0``) bit for bit,
    plus_times within 1e-6.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.models import apps as japps
from hisparse_tpu_torch.models import apps

CFG = dict(sublanes=128, bank_blocks=1, stripes=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _both(dense_or_sparse):
    m = sp.csr_matrix(dense_or_sparse)
    return ht.CSRMatrix.from_scipy(m), hp.CSRMatrix.from_scipy(m)


def _weighted(seed, n=150):
    """tests/test_apps.py's weighted Erdos-Renyi graph."""
    rng = np.random.default_rng(seed)
    dense = rng.random((n, n))
    mask = rng.random((n, n)) < 0.05
    np.fill_diagonal(mask, False)
    return _both(np.where(mask, dense + 0.1, 0.0).astype(np.float32))


def _megahub():
    base = sp.random(3000, 3000, density=0.002, random_state=3, format="lil")
    base[5, :2000] = 1.0
    return _both(base)


def _assert_same_pack(a, b):
    for f in ("perm", "vals", "idxT", "tile_part", "tile_block",
              "tile_first", "tile_last"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_blocks, a.n_parts, a.nnz) == (b.n_blocks, b.n_parts, b.nnz)


@pytest.mark.parametrize("case", ["powerlaw-400", "hub-500"])
def test_pagerank_matches_reference(case):
    args, iters = {"powerlaw-400": ((400, 400, 6), 8),
                   "hub-500": ((500, 500, 8, 1.1), 10)}[case]
    seed = {"powerlaw-400": 3, "hub-500": 6}[case]
    m_r, m_p = ht.powerlaw_csr(*args, seed=seed), hp.powerlaw_csr(
        *args, seed=seed)
    if case == "hub-500":
        assert m_p.row_nnz().max() > 100           # genuinely hubby
    got = hp.PageRank(m_p, hp.SpmvConfig(**CFG), device="cpu").run(
        iters=iters).numpy()
    ref_jax = japps.PageRank(m_r, ht.SpmvConfig(**CFG),
                             interpret=True).run(iters=iters)
    assert _rel(got, ref_jax) <= 1e-5
    ref = hp.pagerank_reference(m_p, iters=iters)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-8)
    assert abs(got.sum() - ref.sum()) < 1e-3


def _tree(app):
    """The port's combine tree of an app's pack, on the CPU."""
    return apps.build_combine(app.wp, app.n, np.argsort(app.inv),
                              app.wp.config.semiring, "cpu")


def test_pagerank_megahub_multilevel_combine():
    """A 2000-degree hub forces a 2-level combine tree; the matrix's pack
    and the tree's are byte-equal to the JAX package's."""
    m_r, m_p = _megahub()
    pr = hp.PageRank(m_p, hp.SpmvConfig(**CFG), device="cpu")
    m_norm = ht.normalize_by_outdegree(m_r.astype(np.float32))
    order = ht.formats.csr.argsort_rows_by_nnz(m_norm, descending=True)
    wp_ref = ht.pack(m_norm, ht.SpmvConfig(**CFG), split_max="auto",
                     col_order=order)
    _assert_same_pack(wp_ref, pr.wp)
    levels = apps.build_combine(pr.wp, pr.n, order, "plus_times", "cpu")
    assert len(levels) == 2
    ref_levels = japps.build_combine(wp_ref, m_r.num_rows, order,
                                     "plus_times", True)
    for (wp_r, _), (wp_p, _) in zip(ref_levels, levels, strict=True):
        _assert_same_pack(wp_r, wp_p)
    got = pr.run(iters=8).numpy()
    np.testing.assert_allclose(got, hp.pagerank_reference(m_p, iters=8),
                               rtol=2e-3, atol=1e-8)


@functools.lru_cache(maxsize=None)
def _sssp_pair(seed):
    m_r, m_p = _weighted(seed)
    return (m_r, m_p, japps.SSSP(m_r, ht.SpmvConfig(**CFG), interpret=True),
            hp.SSSP(m_p, hp.SpmvConfig(**CFG), device="cpu"))


@pytest.mark.parametrize("iters", [25, None])
def test_sssp_matches_reference_and_dijkstra(iters):
    """With the JAX tests' cap of 25 iterations and with none (the early
    exit at the relaxation fixpoint)."""
    m_r, m_p, s_r, s_p = _sssp_pair(4 if iters else 8)
    got = s_p.run(source=3, iters=iters).numpy()
    np.testing.assert_array_equal(got, s_r.run(source=3, iters=iters))
    assert s_p.iters_run == s_r.iters_run
    if iters is None:
        assert s_p.iters_run < 30              # dense ER graph: tiny diameter
    ref = hp.sssp_reference(m_p, 3)
    assert (np.isinf(got) == np.isinf(ref)).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-5)


def test_sssp_combine_matches_reference():
    """The min_plus combine tree (selection weights 0) is byte-equal to
    the JAX package's."""
    _, _, s_r, s_p = _sssp_pair(4)
    for (wp_r, _), (wp_p, _) in zip(s_r.combine, _tree(s_p), strict=True):
        _assert_same_pack(wp_r, wp_p)
    _assert_same_pack(s_r.wp, s_p.wp)


def test_bfs_levels():
    """Levels equal to the JAX ``BFS``'s and scipy's; the max_times packs
    (matrix and combine) byte-equal to the JAX package's."""
    rng = np.random.default_rng(5)
    mask = rng.random((120, 120)) < 0.04
    np.fill_diagonal(mask, False)
    m_r, m_p = _both(mask.astype(np.float32))
    bf = hp.BFS(m_p, hp.SpmvConfig(**CFG), device="cpu")
    bf_r = japps.BFS(m_r, ht.SpmvConfig(**CFG), interpret=True)
    for (wp_r, _), (wp_p, _) in zip([(bf_r.wp, None)] + bf_r.combine,
                                    [(bf.wp, None)] + _tree(bf),
                                    strict=True):
        _assert_same_pack(wp_r, wp_p)
    got = bf.run(source=0, max_iters=30).numpy()
    np.testing.assert_array_equal(got, bf_r.run(source=0, max_iters=30))
    ref = csgraph.shortest_path(m_p.to_scipy(), method="D", unweighted=True,
                                indices=0)
    np.testing.assert_array_equal(
        got, np.where(np.isinf(ref), -1, ref).astype(np.int64))


def test_bfs_masked_matches_dense():
    """tests/test_masked.py's BFS, masked and dense, against the JAX runs
    and scipy."""
    m_r, m_p = ht.powerlaw_csr(3000, 3000, 4, seed=8), hp.powerlaw_csr(
        3000, 3000, 4, seed=8)
    bf = hp.BFS(m_p, device="cpu")
    lv_d = bf.run(source=1).numpy()
    lv_m = bf.run(source=1, masked=True).numpy()
    np.testing.assert_array_equal(lv_m, lv_d)
    assert 0 < len(bf.tiles_streamed) and max(bf.tiles_streamed) <= (
        bf.wp.num_tiles)
    np.testing.assert_array_equal(
        lv_m, japps.BFS(m_r, interpret=True).run(source=1, masked=True))
    ref = csgraph.shortest_path(m_p.to_scipy(), method="D", unweighted=True,
                                indices=1)
    np.testing.assert_array_equal(
        lv_d, np.where(np.isinf(ref), -1, ref).astype(np.int64))


def test_sssp_masked_matches_dense():
    """tests/test_masked.py's SSSP, masked and dense, against the JAX
    masked run: the same distances bit for bit and the same iterations."""
    m0 = sp.csr_matrix(ht.powerlaw_csr(2000, 2000, 4, seed=9).to_scipy())
    m0.sum_duplicates()
    m_r, m_p = _both(m0)
    ss = hp.SSSP(m_p, device="cpu")
    d_dense = ss.run(source=0).numpy()
    it_dense = ss.iters_run
    d_masked = ss.run(source=0, masked=True).numpy()
    np.testing.assert_array_equal(d_masked, d_dense)
    assert ss.iters_run <= it_dense + 1
    s_r = japps.SSSP(m_r, interpret=True)
    np.testing.assert_array_equal(d_masked, s_r.run(source=0, masked=True))
    assert ss.iters_run == s_r.iters_run
    assert len(ss.tiles_streamed) == ss.iters_run


APPS = {"plus_times": hp.PageRank, "min_plus": hp.SSSP, "max_times": hp.BFS}


def _hub_graph(case, semiring):
    """An adjacency whose packed matrix has split hub rows: the megahub
    (its 2000-entry row) or hub-500, as it is for PageRank and transposed
    for SSSP and BFS, which pack the transpose; duplicates summed and
    weights positive."""
    m = (_megahub()[1] if case == "megahub" else hp.powerlaw_csr(
        500, 500, 8, 1.1, seed=6)).to_scipy()
    m = sp.csr_matrix(m if semiring == "plus_times" else m.T)
    m.sum_duplicates()
    m.data = np.abs(m.data).astype(np.float32) + 0.1
    return hp.CSRMatrix.from_scipy(m)


@pytest.mark.parametrize("semiring", list(APPS))
@pytest.mark.parametrize("case", ["megahub", "hub-500"])
def test_app_fold_matches_combine_tree(case, semiring):
    """An app's step folds its renamed y straight into the n ranks, as the
    port's combine tree does through ``y_to_rank`` on the same y: min_plus
    bit for bit, max_times after ``> 0``, plus_times within 1e-6; no
    selection pack is streamed.  Masked SSSP and BFS runs still equal the
    dense runs."""
    m = _hub_graph(case, semiring)
    app = APPS[semiring](m, hp.SpmvConfig(**CFG), device="cpu")
    assert app.combine == [] and app.n_slots == app.n
    assert np.diff(app.fold_ptr.numpy()).max() > 1        # hub rows split
    rng = np.random.default_rng(11)
    x = rng.random(app.n).astype(np.float32)
    if semiring == "min_plus":
        x[rng.random(app.n) < 0.3] = np.inf
    elif semiring == "max_times":
        x = (x < 0.2).astype(np.float32)
    x = torch.from_numpy(x)
    got = app.spmv(x).numpy()
    assert got.shape == (app.n,)
    ref = apps.apply_combine(_tree(app), apps.y_to_rank(
        app.wp, app.op(x, renamed=True))).numpy()[:app.n]
    if semiring == "plus_times":
        assert _rel(got, ref) <= 1e-6
        return
    if semiring == "min_plus":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_array_equal(got > 0, ref > 0)
    src = int(np.argmax(m.row_nnz()))
    dense = app.run(src).numpy()
    np.testing.assert_array_equal(app.run(src, masked=True).numpy(), dense)


def test_pagerank_function_and_reference():
    """``pagerank`` is ``PageRank(...).run``; the device result in
    original row order."""
    m = hp.powerlaw_csr(300, 300, 5, seed=2)
    got = apps.pagerank(m, iters=5, config=hp.SpmvConfig(**CFG),
                        device="cpu")
    assert got.device.type == "cpu" and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), hp.pagerank_reference(m, 5),
                               rtol=2e-3, atol=1e-8)
