"""The port's min_plus and max_times SpMV and SpMM against the JAX
package's on the CPU.

The semiring families (``utils/bench.SEMIRING_FAMILIES``: the parity
sweep's min-plus and max-times, and chain-fp32 in each semiring) go
through the JAX ``SpmvOperator`` in interpret mode (as tests/test_spmv.py
runs it) and through the port's ``SpmvOperator(device="cpu")``, whose
kernel wrappers run the plain PyTorch versions on CPU tensors.
Tolerances:

  * bit-equal against the interpret-mode reference, natural and renamed
    order: every term is rounded once (v + x, or v * x) and min and max
    are exact, so no order of operations can show;
  * 1e-6 relative, max|dy| / max(max|y|, 1) over the finite rows, against
    the float64 oracle ``semiring_f64``, and the same rows infinite: one
    fp32 rounding per term.
"""
import inspect

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu_torch.ops import spmv as spmv_mod
from hisparse_tpu_torch.ops.spmv import (block_runs, gradstream_tiles_plain,
                                         semiring_add, semiring_term,
                                         spmv_masked_tiles_plain,
                                         spmv_tiles_plain)
from hisparse_tpu_torch.utils.bench import (SEMIRING_FAMILIES, family_inputs,
                                           semiring_f64)

TOL_F64 = 1e-6


def _case(fam):
    """(port matrix, reference pack, port pack, x)."""
    args, split, xseed = family_inputs(fam)
    m_r, m_p = ht.powerlaw_csr(*args), hp.powerlaw_csr(*args)
    wr = ht.pack(m_r, ht.SpmvConfig(**fam[1]), split_max=split)
    wp = hp.pack(m_p, hp.SpmvConfig(**fam[1]), split_max=split)
    x = np.random.default_rng(xseed).random(m_p.num_cols).astype(np.float32)
    return m_p, wr, wp, x


def assert_matches_oracle(y, ref):
    y = np.asarray(y)
    fin = np.isfinite(ref)
    assert (np.isfinite(y) == fin).all()
    assert np.abs(y[fin] - ref[fin]).max() <= TOL_F64 * max(
        np.abs(ref[fin]).max(), 1.0)


@pytest.mark.parametrize("fam", SEMIRING_FAMILIES, ids=lambda f: f[0])
def test_family_matches_reference(fam):
    m, wr, wp, x = _case(fam)
    op_r = ht.SpmvOperator(wr, interpret=True)
    op = hp.SpmvOperator(wp, device="cpu")
    y = op(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, np.asarray(op_r(x)))
    np.testing.assert_array_equal(
        op(torch.from_numpy(x), renamed=True).numpy(),
        np.asarray(op_r(x, renamed=True)))
    assert_matches_oracle(y, semiring_f64(m, x, fam[1]["semiring"]))


MATMUL = dict(sublanes=128, bank_blocks=1, stripes=128)


@pytest.mark.parametrize("sr", ["min_plus", "max_times"])
def test_matmul_matches_reference(sr):
    """SpMM at F = 5 against the JAX ``matmul``, natural and renamed, bit
    for bit; each feature is the SpMV of its column."""
    kw = dict(MATMUL, semiring=sr)
    m_r = ht.powerlaw_csr(300, 300, 6, seed=3)
    m_p = hp.powerlaw_csr(300, 300, 6, seed=3)
    op_r = ht.SpmvOperator(ht.pack(m_r, ht.SpmvConfig(**kw), split_max=16),
                           interpret=True)
    op = hp.SpmvOperator(hp.pack(m_p, hp.SpmvConfig(**kw), split_max=16),
                         device="cpu")
    X = np.random.default_rng(8).random((m_p.num_cols, 5)).astype(np.float32)
    Y = op.matmul(torch.from_numpy(X))
    assert Y.shape == (m_p.num_rows, 5)
    np.testing.assert_array_equal(Y.numpy(), np.asarray(op_r.matmul(X)))
    Y_ren = op.matmul(torch.from_numpy(X), renamed=True)
    np.testing.assert_array_equal(Y_ren.numpy(),
                                  np.asarray(op_r.matmul(X, renamed=True)))
    for f in range(5):
        np.testing.assert_array_equal(
            Y_ren[f].numpy(),
            op(torch.from_numpy(X[:, f]), renamed=True).numpy())
        assert_matches_oracle(Y[:, f].numpy(), semiring_f64(m_p, X[:, f], sr))


@pytest.mark.parametrize("sr", ["min_plus", "max_times"])
def test_empty_rows_and_blocks(sr):
    """A row block without tiles comes out at the identity in renamed
    order (+inf, -inf); in natural order max_times clamps empty rows to 0
    (``max(out, 0)``, as the JAX ``unpack_device``, ``unpack_y`` and
    ``matmul`` do) and min_plus leaves them at +inf."""
    kw = dict(sublanes=128, bank_blocks=1, stripes=128, two_choice=False,
              semiring=sr)
    cfg = hp.SpmvConfig(**kw)
    rows = cfg.rows_per_block + 50             # 2 blocks, the second empty
    args = (rows, 200, np.array([2.5, 1.0], np.float32),
            np.array([3, 7], np.int32),
            np.r_[0, 2, np.full(rows - 1, 2)].astype(np.int64))
    wp = hp.pack(hp.CSRMatrix(*args), cfg)
    wr = ht.pack(ht.CSRMatrix(*args), ht.SpmvConfig(**kw))
    start, end = block_runs(wp.tile_block, wp.n_blocks)
    assert wp.n_blocks == 2 and start[1] == end[1]
    x = np.arange(1, 201, dtype=np.float32)
    op = hp.SpmvOperator(wp, device="cpu")
    y_ren = op(torch.from_numpy(x), renamed=True).numpy()
    ident = np.inf if sr == "min_plus" else -np.inf
    assert (y_ren[cfg.rows_per_block:] == ident).all()
    y = op(torch.from_numpy(x)).numpy()
    empty = np.inf if sr == "min_plus" else 0.0
    assert (y[1:] == empty).all()
    assert y[0] == (min(2.5 + x[3], 1.0 + x[7]) if sr == "min_plus"
                    else max(2.5 * x[3], 1.0 * x[7]))
    ref = hp.SpmvOperator.unpack_device(op, torch.from_numpy(y_ren))
    np.testing.assert_array_equal(ref.numpy(), y)
    op_r = ht.SpmvOperator(wr, interpret=True)
    np.testing.assert_array_equal(y, np.asarray(op_r(x)))
    np.testing.assert_array_equal(
        y, np.asarray(op_r.unpack_device(op_r(x, renamed=True))))
    Y = op.matmul(torch.from_numpy(np.stack([x, x[::-1].copy()], 1)))
    assert (Y[1:].numpy() == empty).all()


def test_semiring_add_propagates_nan():
    """min and max take the new term where it is smaller (larger) or NaN:
    a NaN term or accumulator stays NaN, a tie keeps the accumulator."""
    nan, inf = float("nan"), float("inf")
    acc = torch.tensor([inf, nan, 1.0, 0.0])
    v = torch.tensor([1.0, 1.0, nan, -0.0])
    x = torch.tensor([nan, 0.0, 1.0, -0.0])
    got = semiring_add(acc, semiring_term(v, x, "min_plus"), "min_plus")
    assert torch.isnan(got[:3]).all() and got[3] == 0.0
    assert not torch.signbit(got[3])     # the tie with -0 kept acc's +0
    got = semiring_add(torch.full((4,), -inf),
                       semiring_term(v, x, "max_times"), "max_times")
    assert torch.isnan(got[[0, 2]]).all()
    assert got[1] == 0.0 and got[3] == 0.0


@pytest.mark.parametrize("fam", SEMIRING_FAMILIES[2:], ids=lambda f: f[0])
def test_plain_chunks_carry_the_accumulator(fam, monkeypatch):
    """The plain versions walk the stream in chunks of
    ``PLAIN_CHUNK_SLOTS`` slots; a chunk of one tile gives the same bits
    as one chunk of the whole stream, for the SpMV and the masked call."""
    _, _, wp, x = _case(fam)
    op = hp.SpmvOperator(wp, device="cpu")
    args = op.stream_args(torch.from_numpy(x))
    margs = op.masked_args(torch.from_numpy(x),
                           np.arange(0, wp.num_tiles, 2)) + (op.cfg,)
    whole = spmv_tiles_plain(*args, op.cfg)
    whole_m = spmv_masked_tiles_plain(*margs)
    monkeypatch.setattr(spmv_mod, "PLAIN_CHUNK_SLOTS", wp.config.tile_slots)
    torch.testing.assert_close(spmv_tiles_plain(*args, op.cfg), whole,
                               rtol=0, atol=0)
    torch.testing.assert_close(spmv_masked_tiles_plain(*margs), whole_m,
                               rtol=0, atol=0)


def test_gradient_stream_is_plus_times_only():
    """The gradient stream, and the modules that train, refuse a min_plus
    or max_times pack."""
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        semiring="max_times")
    m = hp.powerlaw_csr(200, 200, 4, seed=1)
    op = hp.SpmvOperator(hp.pack(m, cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="plus_times"):
        gradstream_tiles_plain(op.vals, op.idxT, torch.ones_like(op.vals),
                               op.tile_part, op.tile_block, None,
                               torch.zeros(op.wp.n_blocks * 128, 128),
                               torch.zeros(1, cfg.total_blocks, 128, 128),
                               cfg)
    for cls in (hp.DiffSpmv, hp.DiffSpmm):
        with pytest.raises(ValueError):
            cls(m, cfg, device="cpu")


def test_entry_points_default_to_the_card():
    """Every entry point runs on the card unless the caller asks for the
    CPU: its ``device`` defaults to "cuda"."""
    from hisparse_tpu_torch.models import apps
    for fn in (hp.SpmvOperator, hp.spmv, hp.spmm, hp.DiffSpmv,
               hp.StreamDiffSpmv, hp.DiffSpmm, hp.GCN, hp.PageRank, hp.SSSP,
               hp.BFS, hp.pagerank, apps.build_combine):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
