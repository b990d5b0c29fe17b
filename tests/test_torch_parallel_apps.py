"""The port's sharded graph apps (``parallel/apps.py``) against the JAX
package's on the CPU, and the three findings of ADVICE.md.

The JAX apps run on four of conftest's 8 CPU devices in interpret mode
(one jit each, a device loop); the port's on ``Mesh`` over 4
``torch.device("cpu")`` entries, a host loop over the kernels' plain
versions.  Tolerances:

  * PageRank within 1e-5 of the JAX package's, max|d| / max|ref|, in both
    of its fold modes (the port has one fold, ``row_fold``; the order of
    fp32 sums in the SpMV and the fold differs), and within 1e-4 of
    ``pagerank_reference``;
  * SSSP distances and ``iters_run`` equal to the JAX package's in both
    fold modes (min_plus rounds once a term and takes exact minima), and
    within 1e-5 of Dijkstra with the same vertices unreachable;
  * BFS levels equal to the JAX package's in both fold modes and to
    scipy's.
"""
import functools
import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch
from jax.sharding import Mesh as JaxMesh

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.parallel import apps as japps
from hisparse_tpu_torch.models.apps import pagerank_reference, sssp_reference
from hisparse_tpu_torch.parallel import (Mesh, ShardedBFS, ShardedPageRank,
                                         ShardedSSSP)
from hisparse_tpu_torch.parallel import apps as papps

ND = 4                  # shards: four of conftest's eight CPU devices
FOLDS = ["combine", "scatter"]   # the JAX package's fold modes


@pytest.fixture(autouse=True)
def _one_host_thread(monkeypatch):
    """The JAX package packs shards in a forked process pool when the host
    has cores (``hisparse_tpu/parallel/mesh.py:96-108``); a fork of a
    process that runs torch's and XLA's thread pools can deadlock, so the
    references pack here, one shard after another (the same packs).  The
    plain versions run many small torch ops, whose thread pool stalls when
    the test workers oversubscribe the host's cores: one thread here."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:ND]), ("rows",))


def _port_mesh():
    return Mesh(np.array([torch.device("cpu")] * ND), ("rows",))


def _sssp_graph(pkg):
    m = pkg.uniform_sparse_csr(500, 500, 4, seed=9)
    m.data[:] = np.abs(m.data) + 0.1
    return m


@functools.lru_cache(maxsize=None)
def _jax_run(app, fold, split_max="auto"):
    """The JAX app's result (and SSSP's iteration count), run once."""
    mesh = _jax_mesh()
    if app == "pagerank":
        m = ht.powerlaw_csr(600, 600, 6.0, seed=7)
        return japps.ShardedPageRank(m, mesh, interpret=True, fold=fold,
                                     split_max=split_max).run(iters=15), None
    if app == "sssp":
        ss = japps.ShardedSSSP(_sssp_graph(ht), mesh, interpret=True,
                               fold=fold)
        return ss.run(0), ss.iters_run
    m = ht.uniform_sparse_csr(500, 500, 4, seed=9)
    return japps.ShardedBFS(m, mesh, interpret=True, fold=fold).run(0), None


@functools.lru_cache(maxsize=None)
def _port_run(app):
    """The port's app result (and SSSP's iteration count), run once."""
    if app == "pagerank":
        m = hp.powerlaw_csr(600, 600, 6.0, seed=7)
        return ShardedPageRank(m, _port_mesh()).run(iters=15), None
    if app == "sssp":
        ss = ShardedSSSP(_sssp_graph(hp), _port_mesh())
        return ss.run(0), ss.iters_run
    m = hp.uniform_sparse_csr(500, 500, 4, seed=9)
    return ShardedBFS(m, _port_mesh()).run(0), None


@pytest.mark.parametrize("fold", FOLDS)
def test_pagerank_matches_jax(fold):
    """The port's PageRank (its one fold) against the JAX package's in
    the fold mode ``fold``, and against the golden."""
    m = hp.powerlaw_csr(600, 600, 6.0, seed=7)
    got = _port_run("pagerank")[0]
    assert got.shape == (600,)
    got = got.numpy()
    assert _rel(got, _jax_run("pagerank", fold)[0]) <= 1e-5
    assert _rel(got, pagerank_reference(m, iters=15)) <= 1e-4


@functools.lru_cache(maxsize=None)
def _heavy():
    m = hp.powerlaw_csr(400, 400, 8.0, seed=11)
    pr = ShardedPageRank(m, _port_mesh(), split_max=8)
    fan = max(int(np.bincount(
        w.perm[w.perm < pr.st.rows_per_shard].astype(np.int64)).max())
        for w in pr.st.packs)
    return m, fan, pr.run(iters=10).numpy()


@pytest.mark.parametrize("fold", FOLDS)
def test_pagerank_folds_heavy_splits(fold):
    """split_max=8 makes every shard fold rows of several partials: the
    port's fold within 1e-5 of the JAX package's PageRank in the fold
    mode ``fold`` and within 1e-4 of the golden."""
    m, fan, got = _heavy()
    assert fan > 1, "the case must fold hub-split rows"
    ref = japps.ShardedPageRank(ht.powerlaw_csr(400, 400, 8.0, seed=11),
                                _jax_mesh(), interpret=True, split_max=8,
                                fold=fold).run(iters=10)
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, pagerank_reference(m, iters=10)) <= 1e-4


@pytest.mark.parametrize("fold", FOLDS)
def test_sssp_matches_jax(fold):
    """Distances and the iteration count equal to the JAX package's; the
    early exit fires; Dijkstra's distances, unreachable vertices too."""
    m = _sssp_graph(hp)
    d, iters_run = _port_run("sssp")
    d = d.numpy()
    d_ref, it_ref = _jax_run("sssp", fold)
    np.testing.assert_array_equal(d, d_ref)
    assert iters_run == it_ref < m.num_rows - 1
    ref = sssp_reference(m, 0)
    fin = np.isfinite(ref)
    assert (np.isinf(d) == ~fin).all()
    np.testing.assert_allclose(d[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fold", FOLDS)
def test_bfs_matches_jax(fold):
    m = hp.uniform_sparse_csr(500, 500, 4, seed=9)
    lv = _port_run("bfs")[0]
    assert lv.dtype == torch.int64
    lv = lv.numpy()
    np.testing.assert_array_equal(lv, _jax_run("bfs", fold)[0])
    ref = csgraph.shortest_path(m.to_scipy() != 0, unweighted=True,
                                indices=0)
    np.testing.assert_array_equal(lv, np.where(np.isinf(ref), -1, ref))


def test_pagerank_stripes_below_sublanes():
    """The port's fold takes any stripe count: a config with stripes
    below sublanes (which the JAX package's combine fold cannot read)
    runs within 1e-5 of the JAX package's scatter fold and 1e-4 of the
    golden."""
    m = hp.powerlaw_csr(300, 300, 5.0, seed=4)
    cfg = dict(sublanes=128, bank_blocks=1, stripes=64)
    got = ShardedPageRank(m, _port_mesh(), hp.SpmvConfig(**cfg)).run(8)
    ref = japps.ShardedPageRank(ht.powerlaw_csr(300, 300, 5.0, seed=4),
                                _jax_mesh(), ht.SpmvConfig(**cfg),
                                interpret=True, fold="scatter").run(iters=8)
    assert _rel(got.numpy(), ref) <= 1e-5
    assert _rel(got.numpy(), pagerank_reference(m, iters=8)) <= 1e-4


def test_max_times_empty_rows_are_zero():
    """max_times rows with no partial come out at 0 (the JAX package's
    scatter fold gives 0, its combine fold -inf), and every row equals the
    dense row maximum bit for bit."""
    rng = np.random.default_rng(3)
    dense = ((rng.random((300, 300)) < 0.02)
             * rng.random((300, 300))).astype(np.float32)
    dense[::7] = 0.0                       # rows with no term
    m = hp.CSRMatrix.from_scipy(sp.csr_matrix(dense))
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        semiring="max_times")
    x = torch.from_numpy(rng.random(ND * 75).astype(np.float32))
    y = papps._ShardedSemiringStep(m, _port_mesh(), cfg,
                                   "auto").step(x)[:300]
    assert (y[::7] == 0).all() and not torch.isinf(y).any()
    ref = (dense * x.numpy()[None, :300]).max(axis=1)
    np.testing.assert_array_equal(y.numpy(), ref)
