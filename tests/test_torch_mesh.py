"""The port's sharded SpMV (``hisparse_tpu_torch.parallel.mesh``) against
the JAX package's on the CPU: the cases of tests/test_parallel.py:20-250.

The JAX mesh is conftest's 8 CPU devices, its Pallas kernels in interpret
mode; the port's mesh is ``Mesh`` over 8 ``torch.device("cpu")`` entries
of the same shape, whose shards run the kernels' plain versions.  The
same matrices and numpy-seeded x go through both.  Tolerances:

  * every shard pack (``shards[d]``, ``grid[i][j]``) byte-equal to the JAX
    package's over the port shard's own tiles and blocks: the same packer;
    the JAX package pads its shards to the largest one's tile and block
    count, the port does not, and the JAX pad is checked inert;
  * fp32 plus_times natural y within 1e-6 of the JAX package's, as
    max|d| / max(max|ref|, 1) (the order of fp32 sums in the stripe fold
    and, on 2-D meshes, the "cols" combine may differ), and within 1e-4
    of ``spmv_f64``;
  * min_plus and Q8.24 bit-equal to the JAX package's (min and the
    saturating sum of nonnegative words do not depend on order), Q8.24
    also to ``golden.spmv_fixed``.
"""
import functools
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.golden import float_to_fixed, spmv_f64, spmv_fixed
from hisparse_tpu.parallel import mesh as jmesh
from hisparse_tpu_torch.models.perf_model import estimate_pack
from hisparse_tpu_torch.parallel import mesh as pmesh
from hisparse_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce,
                                              ring_allgather_time,
                                              ring_allreduce_time)

TOL_REF = 1e-6
TOL_F64 = 1e-4
MESHES = {"1d": ((8,), ("rows",)), "2d": ((4, 2), ("rows", "cols")),
          "mh": ((2, 4), ("hosts", "chips"))}
CLASSES = {"1d": ("ShardedSpmv", "ShardedSpmv"),
           "2d": ("ShardedSpmv2D", "ShardedSpmv2D"),
           "mh": ("ShardedSpmvMultiHost", "ShardedSpmvMultiHost")}
# name: (mesh, config, generator and its arguments, split_max, x seed,
# value kind); tests/test_parallel.py's cases
CASES = {
    "golden": ("1d", dict(sublanes=128, bank_blocks=1, stripes=128),
               ("uniform_sparse_csr", (900, 1200, 8), dict(seed=1)),
               None, 0, "fp32"),
    "powerlaw-split": ("1d", dict(sublanes=128, bank_blocks=1, stripes=64),
                       ("powerlaw_csr", (700, 900, 9),
                        dict(alpha=1.2, seed=2)), 32, 1, "fp32"),
    "block-major": ("1d", dict(sublanes=128, bank_blocks=2, stripes=128,
                               block_major=True, classes_per_group=2,
                               two_choice=True),
                    ("powerlaw_csr", (900, 20000, 6), dict(seed=3)),
                    None, 2, "fp32"),
    "min-plus": ("1d", dict(sublanes=128, bank_blocks=1, stripes=128,
                            semiring="min_plus"),
                 ("powerlaw_csr", (900, 1100, 7), dict(alpha=1.2, seed=4)),
                 32, 3, "fp32"),
    "fixed": ("1d", dict(sublanes=128, bank_blocks=1, stripes=128,
                         dtype="fixed", two_choice=False),
              ("uniform_sparse_csr", (600, 800, 6), dict(seed=7)),
              None, 7, "fixed"),
    "fixed-saturating": ("1d", dict(sublanes=128, bank_blocks=1,
                                    stripes=128, dtype="fixed",
                                    two_choice=False),
                         ("uniform_sparse_csr", (500, 640, 8),
                          dict(seed=21)), None, 21, "saturating"),
    "split-auto": ("1d", dict(sublanes=128, bank_blocks=1, stripes=64),
                   ("powerlaw_csr", (800, 1000, 8), dict(alpha=1.1, seed=5)),
                   "auto", 5, "fp32"),
    "2d": ("2d", dict(sublanes=128, bank_blocks=1, stripes=64),
           ("powerlaw_csr", (900, 1100, 8), dict(alpha=1.1, seed=3)),
           "auto", 0, "fp32"),
    "2d-min-plus": ("2d", dict(sublanes=128, bank_blocks=1, stripes=64,
                               semiring="min_plus", two_choice=False),
                    ("uniform_sparse_csr", (600, 900, 5), dict(seed=4)),
                    None, 1, "fp32"),
    "multihost": ("mh", dict(sublanes=128, bank_blocks=1, stripes=64),
                  ("powerlaw_csr", (900, 1100, 8), dict(alpha=1.1, seed=3)),
                  "auto", 0, "fp32"),
}


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


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _jax_mesh(kind):
    shape, names = MESHES[kind]
    return JaxMesh(np.array(jax.devices()[:8]).reshape(shape), names)


def _port_mesh(kind):
    shape, names = MESHES[kind]
    return Mesh(np.array([torch.device("cpu")] * 8).reshape(shape), names)


def _matrices(gen, args, kw, values):
    """The same matrix in both packages (Q8.24 words for a fixed case, as
    tests/test_parallel.py makes them)."""
    m_r = getattr(ht, gen)(*args, **kw)
    m_p = getattr(hp, gen)(*args, **kw)
    np.testing.assert_array_equal(m_r.data, m_p.data)
    if values != "fp32":
        data = (float_to_fixed(m_r.data / m_r.num_cols) if values == "fixed"
                else float_to_fixed(np.full(m_r.nnz, 120.0)))
        m_r = ht.CSRMatrix(m_r.num_rows, m_r.num_cols, data, m_r.indices,
                           m_r.indptr)
        m_p = hp.CSRMatrix(m_p.num_rows, m_p.num_cols, data, m_p.indices,
                           m_p.indptr)
    return m_r, m_p


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX op, port op, matrix, x, JAX natural y) of a case, built once."""
    kind, cfg, (gen, args, kw), split, xseed, values = CASES[name]
    m_r, m_p = _matrices(gen, args, kw, values)
    rng = np.random.default_rng(xseed)
    if values == "fp32":
        x = rng.random(m_r.num_cols).astype(np.float32)
    else:
        x = float_to_fixed(rng.random(m_r.num_cols)
                           * (2.0 if values == "saturating" else 1.0))
    jcls, pcls = CLASSES[kind]
    ref = getattr(jmesh, jcls)(m_r, _jax_mesh(kind), ht.SpmvConfig(**cfg),
                               split_max=split, interpret=True)
    op = getattr(pmesh, pcls)(m_p, _port_mesh(kind), hp.SpmvConfig(**cfg),
                              split_max=split)
    y_ref = ref.unpack_y(ref(x))[:m_r.num_rows]
    return ref, op, m_r, x, y_ref


def _packs(op):
    return (op.shards if hasattr(op, "shards")
            else [w for row in op.grid for w in row])


TILE_FIELDS = ("vals", "idxT", "tile_part", "tile_block", "tile_first",
               "class_map")


def _assert_shard_equal(wr, wp):
    """The port's shard ``wp`` is the JAX shard ``wr`` before the JAX
    package padded it (``hisparse_tpu/parallel/mesh.py:_pad_tiles``):
    byte-equal over ``wp``'s own tiles and renamed rows, the last tile
    flag on ``wp``'s last tile, and the JAX pad inert (identity values,
    index 0, tiles of ``wp``'s last block, pad rows)."""
    T, R = wp.num_tiles, wp.perm.shape[0]
    assert T > 0 and wr.num_tiles >= T and wr.n_blocks >= wp.n_blocks
    for f in TILE_FIELDS:
        a, b = getattr(wr, f), getattr(wp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a[:T], b, f)
    np.testing.assert_array_equal(wr.tile_last[:T - 1], wp.tile_last[:T - 1])
    assert wp.tile_last[-1] == 1 and wr.tile_last[-1] == 1
    assert not wr.tile_last[T - 1:-1].any()
    np.testing.assert_array_equal(wr.perm[:R], wp.perm)
    assert (wr.perm[R:] == wr.num_rows).all()
    pad = np.inf if wp.config.semiring == "min_plus" else 0
    assert (wr.vals[T:] == pad).all() and not wr.idxT[T:].any()
    assert (wr.tile_block[T:] == wp.n_blocks - 1).all()
    assert not wr.tile_part[T:].any() and not wr.tile_first[T:].any()
    assert ((wr.num_rows, wr.num_cols, wr.n_parts, wr.nnz)
            == (wp.num_rows, wp.num_cols, wp.n_parts, wp.nnz))


@pytest.mark.parametrize("name", sorted(CASES))
def test_shards_byte_equal(name):
    """Every shard pack byte-equal to the JAX package's over its own
    tiles and blocks, the JAX padding inert (:func:`_assert_shard_equal`)."""
    ref, op, *_ = _case(name)
    a, b = _packs(ref), _packs(op)
    assert len(a) == len(b) == 8
    for wr, wp in zip(a, b):
        _assert_shard_equal(wr, wp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_y_matches_jax(name):
    """Natural y against the JAX mesh: fp32 plus_times within 1e-6 and
    within 1e-4 of spmv_f64; min_plus and Q8.24 bit for bit (Q8.24 also
    equal to golden.spmv_fixed)."""
    ref, op, m, x, y_ref = _case(name)
    y = op.unpack_y(op(x))
    assert y.shape == (m.num_rows,)
    y = y.numpy()
    cfg = op.cfg
    if cfg.dtype == "fixed":
        assert y.dtype == np.uint32
        gold = spmv_fixed(m, x, data_raw=m.data)
        np.testing.assert_array_equal(y, gold)
        np.testing.assert_array_equal(y, y_ref)
        if name == "fixed-saturating":
            assert (gold == np.uint32(0xFFFFFFFF)).any()
    elif cfg.semiring == "min_plus":
        np.testing.assert_array_equal(y, y_ref)
    else:
        assert _err(y, y_ref) <= TOL_REF
        assert _err(y, spmv_f64(m, x)) <= TOL_F64


def test_2d_and_multihost_match_1d():
    """The 4 x 2 and 2 x 4 meshes agree with the 1-D mesh on one matrix
    (the JAX package's multi-host check, tests/test_parallel.py:346)."""
    _, op2, m, x, _ = _case("2d")
    _, opm, *_ = _case("multihost")
    m_p = hp.CSRMatrix(m.num_rows, m.num_cols, m.data, m.indices, m.indptr)
    op1 = pmesh.ShardedSpmv(m_p, _port_mesh("1d"), op2.cfg, split_max="auto")
    y1 = op1.unpack_y(op1(x)).numpy()
    assert (opm.n_hosts, opm.chips_per_host) == (2, 4)
    for op in (op2, opm):
        assert _err(op.unpack_y(op(x)).numpy(), y1) <= TOL_REF


@functools.lru_cache(maxsize=None)
def _paged():
    cfg = dict(sublanes=128, bank_blocks=1, stripes=128,
               block_major=True, classes_per_group=1, two_choice=False,
               steal_mantissa=True)
    m_r = ht.powerlaw_csr(1100, 40000, 7, seed=6)
    m_p = hp.powerlaw_csr(1100, 40000, 7, seed=6)
    x = np.random.default_rng(4).random(m_r.num_cols).astype(np.float32)
    ref = jmesh.ShardedSpmv(m_r, _jax_mesh("1d"), ht.SpmvConfig(**cfg),
                            interpret=True, variant="paged")
    op = pmesh.ShardedSpmv(m_p, _port_mesh("1d"), hp.SpmvConfig(**cfg))
    return ref, op, m_r, x


def test_paged_shards_match_jax_paged_variant():
    """Shard packs of 3 column partitions (the JAX package's paged
    kernel; the port's one kernel serves them): byte-equal shards, y
    within 1e-6 of the JAX paged variant and 1e-4 of spmv_f64."""
    ref, op, m, x = _paged()
    assert all(w.n_parts == 3 for w in op.shards)
    for wr, wp in zip(ref.shards, op.shards):
        _assert_shard_equal(wr, wp)
    y = op.unpack_y(op(x)).numpy()
    assert _err(y, ref.unpack_y(ref(x))[:m.num_rows]) <= TOL_REF
    assert _err(y, spmv_f64(m, x)) <= TOL_F64


def test_renamed_y_per_shard():
    """``__call__`` gives each shard's renamed y, one row block of
    ``stripes`` x 128 rows after another, folding to the shard's rows with
    ``Wavepack.unpack_y``."""
    ref, op, m, x, _ = _case("powerlaw-split")
    ys = op(x)
    assert len(ys) == 8
    # each shard keeps its own tile count: nothing pads them to the largest
    assert len({w.num_tiles for w in op.shards}) > 1
    out = []
    for wp, y in zip(op.shards, ys):
        assert y.shape == (wp.n_blocks * op.cfg.stripes * 128,)
        out.append(wp.unpack_y(y.numpy()))
    np.testing.assert_array_equal(np.concatenate(out),
                                  op.unpack_y(ys).numpy())


def test_perf_estimate_terms():
    """The compute term is ``estimate_pack`` of each shard on the card's
    rates; the link terms and the aggregate are None without a bandwidth
    and the ring formulas with one."""
    _, op1, *_ = _case("powerlaw-split")
    ests, gops = op1.perf_estimate()
    assert [e.time_s for e in ests] == [estimate_pack(w).time_s
                                        for w in op1.shards]
    nnz = sum(w.nnz for w in op1.shards)
    assert gops == pytest.approx(2 * nnz / max(e.time_s for e in ests) / 1e9)

    _, op2, *_ = _case("2d")
    ests, gops, t_comp, t_comb = op2.perf_estimate()
    flat = [e.time_s for row in ests for e in row]
    assert flat == [estimate_pack(w).time_s for w in _packs(op2)]
    assert t_comp == max(flat) and t_comb is None and gops is None
    _, gops, _, t_comb = op2.perf_estimate(link_gbps=100.0)
    y_bytes = max(row[0].n_blocks for row in op2.grid) \
        * op2.cfg.stripes * 128 * 4
    assert t_comb == ring_allreduce_time(y_bytes, 2, 100.0) > 0
    nnz = sum(w.nnz for w in _packs(op2))
    assert gops == pytest.approx(2 * nnz / (t_comp + t_comb) / 1e9)

    _, opm, *_ = _case("multihost")
    _, gops, t_comp, t_link, t_host = opm.perf_estimate()
    assert t_link is None and t_host is None and gops is None
    _, _, _, _, t_host = opm.perf_estimate(chained=False)
    assert t_host == 0.0
    _, gops, t_comp, t_link, t_host = opm.perf_estimate(link_gbps=100.0,
                                                        host_gbps=50.0)
    x_bytes = opm.grid[0][0].num_cols * 4 * 4
    assert t_host == ring_allgather_time(x_bytes, 2, 50.0) > 0
    nnz = sum(w.nnz for w in _packs(opm))
    assert gops == pytest.approx(2 * nnz / (t_comp + t_link + t_host) / 1e9)


def test_ring_model_shape():
    """The ring terms: zero on one shard, linear in bytes, inverse in the
    bandwidth, 2*bytes/bw as the ring grows (all-reduce)."""
    b = 1 << 20
    assert ring_allreduce_time(b, 1, 10.0) == 0.0
    assert ring_allgather_time(b, 1, 10.0) == 0.0
    t2, t8 = ring_allreduce_time(b, 2, 10.0), ring_allreduce_time(b, 8, 10.0)
    assert 0 < t2 < t8 < 2 * b / 10e9
    assert ring_allreduce_time(2 * b, 8, 10.0) == 2 * t8
    assert ring_allreduce_time(b, 8, 20.0) == t8 / 2
    assert ring_allreduce_time(b, 256, 10.0) > 0.99 * 2 * b / 10e9
    assert ring_allgather_time(b, 4, 10.0) == 0.75 * b / 10e9


def test_rejections():
    """A Q8.24 pack on a 2-D mesh, a one-axis multi-host mesh and a
    one-axis 2-D mesh raise ``ValueError``, as the JAX package's do."""
    m = hp.uniform_sparse_csr(300, 400, 4, seed=5)
    with pytest.raises(ValueError):
        pmesh.ShardedSpmv2D(m, _port_mesh("2d"), hp.SpmvConfig(
            sublanes=128, bank_blocks=1, stripes=64, dtype="fixed",
            two_choice=False))
    with pytest.raises(ValueError, match="hosts, chips"):
        pmesh.ShardedSpmvMultiHost(m, _port_mesh("1d"), hp.SpmvConfig())
    with pytest.raises(ValueError, match="two axes"):
        pmesh.ShardedSpmv2D(m, _port_mesh("1d"), hp.SpmvConfig())


def test_collectives_fold_in_mesh_order():
    """all_reduce folds from part 0 in mesh order, so its sum has the same
    bits every run and equals the left fold; min and max propagate NaN;
    all_gather concatenates in mesh order and copies to each target."""
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy((rng.standard_normal(4096)
                               * 10.0 ** rng.integers(-8, 9, 4096)).astype(
                                   np.float32)) for _ in range(4)]
    left = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    out = all_reduce(parts, "sum")
    assert len(out) == 4
    for o in out + all_reduce(parts, "sum"):
        assert torch.equal(o.view(torch.int32), left.view(torch.int32))
    one = all_reduce(parts, "sum", [torch.device("cpu")])
    assert len(one) == 1 and torch.equal(one[0], left)
    nan = [p.clone() for p in parts]
    nan[2][7] = float("nan")
    for op, f in (("min", torch.minimum), ("max", torch.maximum)):
        r = all_reduce(nan, op)[0]
        assert torch.isnan(r[7]) and torch.equal(
            r[8:], f(f(f(nan[0], nan[1]), nan[2]), nan[3])[8:])
    g = all_gather([p.reshape(2, -1) for p in parts], 0)
    assert len(g) == 4 and g[0].shape == (8, 2048)
    assert torch.equal(g[3], torch.cat(parts).reshape(8, 2048))
    with pytest.raises(ValueError, match="unknown reduction"):
        all_reduce(parts, "prod")


def test_mesh_devices():
    """A mesh holds torch devices in its grid's shape, repeats allowed; a
    CUDA device without its card raises (nothing falls back to the CPU);
    axis names must name each axis once."""
    mesh = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("rows", "cols"))
    assert mesh.shape == (4, 2) and mesh.size == 8
    assert mesh.device_list() == [torch.device("cpu")] * 8
    missing = ("cuda:0" if not torch.cuda.is_available()
               else f"cuda:{torch.cuda.device_count()}")
    with pytest.raises(RuntimeError, match="mesh device"):
        Mesh([missing] * 4, ("rows",))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("rows", "cols"))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("rows", "rows"))
