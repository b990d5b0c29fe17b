"""The port's renamed -> natural fold against the JAX package's host
recombine ``Wavepack.unpack_y`` on the CPU, bit for bit.

``row_fold_plain`` (what ``SpmvOperator.unpack_device`` and the Q8.24
forward run on CPU tensors, and what the CUDA kernel of
``csrc/row_fold.cu`` is held to on the card) folds each natural row's
partials in ascending renamed order from the identity, as ``np.add.at``,
``np.minimum.at`` and ``np.maximum.at`` do in ``unpack_y``.  So the
comparisons are exact: same bits (NaNs in the same places), on packs
whose hub rows are split into many partials, in plus_times, min_plus with
+inf partials, max_times with empty rows (clamped to 0) and Q8.24 with
rows whose sum saturates, for (renamed,) and (F, renamed) inputs.  The
reference's pack is byte-equal to the port's (tests/test_torch_formats.py),
so both ``unpack_y`` run on the same perm.
"""
import dataclasses

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops import golden
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (FOLD_THREAD_MAX, fold_plan,
                                         row_fold, row_fold_plain)

# unpack_y's numpy folds warn of the NaN partials they propagate
pytestmark = pytest.mark.filterwarnings(
    "ignore:invalid value encountered:RuntimeWarning")

ALGEBRAS = ("plus_times", "min_plus", "max_times", "fixed")
SPLIT = 8          # hub rows of up to 900 nonzeros split into 113 partials


def _matrix(lib):
    """A power-law matrix with rows 40-59 emptied (the packer still gives
    each a renamed row, which the SpMV leaves at the identity)."""
    m = lib.powerlaw_csr(700, 900, 8, alpha=1.1, seed=9)
    a = m.to_scipy().tolil()
    a[40:60] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return lib.CSRMatrix.from_scipy(a)


def _config(alg):
    kw = dict(sublanes=128, bank_blocks=1, stripes=128, two_choice=False)
    return dict(kw, dtype="fixed") if alg == "fixed" else dict(
        kw, semiring=alg)


def _packs(alg):
    """(the port's pack, the reference's) of the same matrix."""
    m, m_r = _matrix(hp), _matrix(ht)
    if alg == "fixed":
        data = golden.float_to_fixed(np.abs(m.data) / 8)
        m = dataclasses.replace(m, data=data)
        m_r = dataclasses.replace(m_r, data=data.copy())
    wp = hp.pack(m, hp.SpmvConfig(**_config(alg)), split_max=SPLIT)
    wr = ht.pack(m_r, ht.SpmvConfig(**_config(alg)), split_max=SPLIT)
    np.testing.assert_array_equal(wp.perm, wr.perm)
    return wp, wr


def _renamed(alg, n, seed):
    """A renamed y of n rows with the algebra's special values: +inf
    partials (min_plus), -inf and signed zeros (max_times), a NaN (the
    float algebras), Q8.24 words large enough to saturate hub sums."""
    rng = np.random.default_rng(seed)
    if alg == "fixed":
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    y = rng.standard_normal(n).astype(np.float32)
    pick = rng.random(n)
    if alg == "min_plus":
        y[pick < 0.2] = np.inf
    elif alg == "max_times":
        y[pick < 0.2] = -np.inf
        y[(pick >= 0.2) & (pick < 0.3)] = -0.0
        y[(pick >= 0.3) & (pick < 0.4)] = 0.0
    y[n // 2] = np.nan
    return y


def _bits(a):
    """The words of a float32 or uint32 array, NaNs as one word."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        a = np.where(np.isnan(a), np.float32(np.nan), a)
    return a.view(np.uint32)


def _fold(wp, y, alg):
    """row_fold_plain of a numpy renamed y ((n,) or (F, n)) on wp's plan."""
    idx, ptr, _ = (torch.from_numpy(a) for a in fold_plan(wp.perm,
                                                           wp.num_rows))
    t = torch.from_numpy(y.view(np.int32) if alg == "fixed" else y)
    out = row_fold_plain(t, idx, ptr, alg).numpy()
    return out.view(np.uint32) if alg == "fixed" else out


@pytest.mark.parametrize("alg", ALGEBRAS)
def test_fold_matches_unpack_y(alg):
    """The plain fold is bit-equal to the port's and the reference's
    ``unpack_y`` on a hub-split pack, special values included."""
    wp, wr = _packs(alg)
    valid = wp.perm[wp.perm < wp.num_rows]
    assert np.bincount(valid).max() > FOLD_THREAD_MAX        # hub rows
    y = _renamed(alg, wp.perm.size, 1)
    if alg == "max_times":
        y[(wp.perm >= 40) & (wp.perm < 60)] = -np.inf        # empty rows
    got = _bits(_fold(wp, y, alg))
    np.testing.assert_array_equal(got, _bits(wp.unpack_y(y)))
    np.testing.assert_array_equal(got, _bits(wr.unpack_y(y)))
    if alg == "fixed":
        assert (got == 0xFFFFFFFF).sum() > 10                # saturated
    if alg == "max_times":
        assert (got[40:60] == 0).all()                       # empty rows
    if alg == "min_plus":
        assert np.isinf(got.view(np.float32)).sum() > 0


@pytest.mark.parametrize("alg", ALGEBRAS)
def test_fold_of_features(alg):
    """A (F, renamed) input folds each feature as its own vector."""
    wp, _ = _packs(alg)
    Y = np.stack([_renamed(alg, wp.perm.size, s) for s in (2, 3, 4)])
    got = _fold(wp, Y, alg)
    assert got.shape == (3, wp.num_rows)
    for f in range(3):
        np.testing.assert_array_equal(_bits(got[f]),
                                      _bits(wp.unpack_y(Y[f])))


def test_fold_plan_orders_partials():
    """Each row's partials are its renamed positions in ascending order,
    every valid position once; long_rows lists the rows of more than
    FOLD_THREAD_MAX partials."""
    wp, _ = _packs("plus_times")
    idx, ptr, long_rows = fold_plan(wp.perm, wp.num_rows)
    assert idx.dtype == ptr.dtype == long_rows.dtype == np.int32
    assert ptr[0] == 0 and ptr[-1] == idx.size == (
        wp.perm < wp.num_rows).sum()
    for r in range(wp.num_rows):
        part = idx[ptr[r]:ptr[r + 1]]
        np.testing.assert_array_equal(part, np.flatnonzero(wp.perm == r))
    np.testing.assert_array_equal(
        long_rows, np.flatnonzero(np.diff(ptr) > FOLD_THREAD_MAX))
    assert long_rows.size > 0


@pytest.mark.parametrize("alg", ALGEBRAS)
def test_operator_paths_fold_in_order(alg):
    """Through ``SpmvOperator`` on the CPU: natural-order y of
    ``forward`` (and, for the float algebras, ``masked`` and ``matmul``)
    is bit-equal to ``unpack_y`` of the same call's renamed y; the CPU
    wrapper launches nothing."""
    wp, _ = _packs(alg)
    op = hp.SpmvOperator(wp, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.random(wp.num_cols).astype(np.float32)
    if alg == "fixed":
        x = golden.float_to_fixed(x)
    before = _kernels.fold_launches
    y = op(x)
    y_ren = op(x, renamed=True).numpy()
    np.testing.assert_array_equal(_bits(y.numpy()),
                                  _bits(wp.unpack_y(y_ren)))
    if alg == "fixed":
        assert y.dtype == torch.uint32 and y.device.type == "cpu"
        return
    active = np.flatnonzero(rng.random(wp.num_cols) < 0.3)
    xs = np.zeros_like(x) if alg != "min_plus" else np.full_like(x, np.inf)
    xs[active] = x[active]
    ym = op.masked(xs, active).numpy()
    ym_ren = op.masked(xs, active, renamed=True).numpy()
    np.testing.assert_array_equal(_bits(ym), _bits(wp.unpack_y(ym_ren)))
    X = torch.from_numpy(rng.random((wp.num_cols, 3)).astype(np.float32))
    Y = op.matmul(X).numpy()
    Y_ren = op.matmul(X, renamed=True).numpy()
    for f in range(3):
        np.testing.assert_array_equal(_bits(Y[:, f]),
                                      _bits(wp.unpack_y(Y_ren[f])))
    assert _kernels.fold_launches == before


def test_row_fold_takes_cpu_tensors_only_as_plain():
    """On CPU tensors the wrapper is the plain version; a device the port
    has no kernel for raises."""
    wp, _ = _packs("plus_times")
    plan = [torch.from_numpy(a) for a in fold_plan(wp.perm, wp.num_rows)]
    y = torch.from_numpy(_renamed("plus_times", wp.perm.size, 7))
    np.testing.assert_array_equal(
        _bits(row_fold(y, *plan, "plus_times").numpy()),
        _bits(row_fold_plain(y, *plan[:2], "plus_times").numpy()))
    with pytest.raises(ValueError):
        row_fold(y.to("meta"), *plan, "plus_times")
