"""The port's packed-stream SpMM against the JAX package's on the CPU.

The chain, block-major steal, multi-partition and column-order cases of
tests/test_spmm.py go through ``hisparse_tpu.SpmvOperator.matmul`` in
interpret mode and through the port's ``SpmvOperator(device="cpu")
.matmul``, whose kernel wrapper runs the plain PyTorch version
``spmm_tiles_plain`` on CPU tensors.  Tolerances, as
max|d| / max(max|ref|, 1):

  * 1e-6 against the interpret-mode reference, natural and renamed order:
    only the order of fp32 sums may differ (hub-split recombine, stripe
    fold), bf16 values included (each widened exactly);
  * bit-equal, within the port, between a feature of the SpMM and the
    SpMV of that column, and between chunkings of the features (up to
    ``SPMM_MAX_F`` a launch against 16, the narrow instantiations' width):
    each feature sums its terms in stream order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (SPMM_MAX_F, build_xt,
                                         build_xt_multi, spmm_tiles_plain,
                                         wavepack_spmm)

TOL_REF = 1e-6

CHAIN = dict(sublanes=128, bank_blocks=1, stripes=128)
BM = dict(sublanes=128, bank_blocks=2, stripes=128, block_major=True,
          classes_per_group=2, steal_mantissa=True, two_choice=False)
MULTIPART = dict(sublanes=128, bank_blocks=1, stripes=32)
BF16 = dict(CHAIN, dtype="bf16")

# name: (config, matrix generator and args, F, X seed, pack kwargs,
# JAX operator variant)
CASES = {
    "chain": (CHAIN, ("uniform_sparse_csr", (256, 256, 10), 1), 5, 0, {},
              "auto"),
    "bm-steal": (BM, ("powerlaw_csr", (300, 300, 6), 3), 5, 0, {}, "auto"),
    "multipart": (MULTIPART, ("powerlaw_csr", (4196, 16684, 5), 4), 3, 7,
                  {}, "paged"),
    "col-order": (CHAIN, ("powerlaw_csr", (260, 260, 5), 9), 5, 10,
                  {"col_order": "degree"}, "auto"),
    "bf16": (BF16, ("powerlaw_csr", (300, 300, 6), 3), 5, 4, {}, "auto"),
}


@pytest.fixture(autouse=True)
def _one_host_thread():
    """The plain versions run many small torch ops, whose thread pool
    stalls when the test workers oversubscribe the host's cores: one
    thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _case(name):
    kw, (gen, args, seed), F, xseed, pack_kw, variant = CASES[name]
    m_r = getattr(ht, gen)(*args, seed=seed)
    m_p = getattr(hp, gen)(*args, seed=seed)
    op_r = ht.SpmvOperator(ht.pack(m_r, ht.SpmvConfig(**kw), **pack_kw),
                           interpret=True, variant=variant)
    op = hp.SpmvOperator(hp.pack(m_p, hp.SpmvConfig(**kw), **pack_kw),
                         device="cpu")
    X = np.random.default_rng(xseed).standard_normal(
        (m_p.num_cols, F)).astype(np.float32)
    return m_p, op_r, op, X


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_matches_reference(name):
    m, op_r, op, X = _case(name)
    Y = op.matmul(torch.from_numpy(X))
    assert Y.shape == (m.num_rows, X.shape[1]) and torch.isfinite(Y).all()
    assert _err(Y, np.asarray(op_r.matmul(X))) <= TOL_REF
    Y_ren = op.matmul(torch.from_numpy(X), renamed=True)
    assert _err(Y_ren, np.asarray(op_r.matmul(X, renamed=True))) <= TOL_REF
    ref = m.to_scipy().astype(np.float64) @ X.astype(np.float64)
    # steal_mantissa and bf16 round the values (bf16: 8e-3, as
    # tests/test_formats.py:433 allows the bf16 SpMV)
    assert _err(Y, ref) <= (5e-4 if op.cfg.steal_mantissa
                            else 8e-3 if op.cfg.dtype == "bf16" else 1e-4)
    # each feature is the SpMV of its column, bit for bit
    for f in range(X.shape[1]):
        np.testing.assert_array_equal(
            Y_ren[f].numpy(),
            op(torch.from_numpy(X[:, f]), renamed=True).numpy())


def test_spmm_chunking_is_bit_exact():
    """More features than one launch takes: the chunks' results equal
    the features run alone."""
    _, _, op, _ = _case("bm-steal")
    F = SPMM_MAX_F + 4
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (op.wp.num_cols, F)).astype(np.float32))
    Y = op.matmul(X, renamed=True)
    assert Y.shape[0] == F
    for f0, f1 in ((0, 3), (3, SPMM_MAX_F), (SPMM_MAX_F, F)):
        np.testing.assert_array_equal(
            Y[f0:f1].numpy(), op.matmul(X[:, f0:f1], renamed=True).numpy())


@pytest.mark.parametrize("F", [17, 36, 47, 64, 65, 100, 256])
@pytest.mark.parametrize("name", ["bm-steal", "chain"])
def test_matmul_wide_chunks_equal_narrow_chunks(name, F):
    """matmul at F features (chunks of up to SPMM_MAX_F a launch) bit for
    bit the same features taken 16 at a time."""
    _, _, op, _ = _case(name)
    X = torch.from_numpy(np.random.default_rng(F).standard_normal(
        (op.wp.num_cols, F)).astype(np.float32))
    n = _kernels.SPMM_NARROW_F
    Y = op.matmul(X, renamed=True)
    assert Y.shape[0] == F
    want = torch.cat([op.matmul(X[:, f0:f0 + n], renamed=True)
                      for f0 in range(0, F, n)])
    np.testing.assert_array_equal(Y.numpy(), want.numpy())


def test_spmm_wrapper_takes_up_to_max_f():
    """wavepack_spmm takes an xt of up to SPMM_MAX_F features, each equal
    to the plain version's, and raises ValueError for a wider one."""
    _, _, op, _ = _case("chain")
    X = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (op.wp.num_cols, SPMM_MAX_F + 4)).astype(np.float32))
    args = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
            op.run_end)
    xt = build_xt_multi(X[:, :SPMM_MAX_F], op.cfg, op.wp.n_parts)
    acc = wavepack_spmm(*args, xt, op.cfg)
    assert acc.shape == (SPMM_MAX_F, op.wp.n_blocks * op.cfg.sublanes, 128)
    torch.testing.assert_close(acc, spmm_tiles_plain(*args, xt, op.cfg),
                               rtol=0, atol=0)
    wide = build_xt_multi(X, op.cfg, op.wp.n_parts)
    for F in (None, 1):
        with pytest.raises(ValueError, match=f"<= {SPMM_MAX_F}"):
            wavepack_spmm(*args, wide, op.cfg, F=F)


def test_spmm_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; on a device without a kernel it raises."""
    _, _, op, X = _case("chain")
    xt = build_xt_multi(torch.from_numpy(X), op.cfg, op.wp.n_parts)
    args = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
            op.run_end, xt, op.cfg)
    before = _kernels.spmm_launches
    F = X.shape[1]
    acc = wavepack_spmm(*args, F=F)
    assert _kernels.spmm_launches == before
    assert acc.shape == (F, op.wp.n_blocks * op.cfg.sublanes, 128)
    torch.testing.assert_close(acc, spmm_tiles_plain(*args, F=F), rtol=0,
                               atol=0)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="no wavepack_spmm kernel"):
        wavepack_spmm(*meta)


def test_spmm_rejects_bad_input():
    m = hp.uniform_sparse_csr(128, 128, 4, seed=13)
    op = hp.SpmvOperator(hp.pack(m, hp.SpmvConfig(**CHAIN)), device="cpu")
    with pytest.raises(ValueError, match="num_cols, F"):
        op.matmul(np.zeros(m.num_cols, np.float32))
    with pytest.raises(ValueError, match="num_cols, F"):
        op.matmul(np.zeros((m.num_cols + 1, 2), np.float32))
    # a Q8.24 pack has no SpMM (the JAX package refuses it too); bf16
    # packs run (the "bf16" case above)
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        dtype="fixed")
    m_fixed = dataclasses.replace(m, data=np.ones(m.nnz, np.uint32))
    with pytest.raises(ValueError, match="float packs"):
        hp.spmm(hp.pack(m_fixed, cfg), np.zeros((m.num_cols, 2), np.float32),
                device="cpu")


# build_xt_multi's packs: (config, column partitions)
XT_PACKS = {
    "chain": (dict(sublanes=128, bank_blocks=2, stripes=128,
                   two_choice=True), 1),
    "bm-two-choice": (dict(sublanes=128, bank_blocks=2, stripes=128,
                           block_major=True, classes_per_group=2,
                           two_choice=True), 1),
    "multipart": (dict(sublanes=128, bank_blocks=1, stripes=32), 3),
}


@pytest.mark.parametrize("F", [1, 3, 5, 8, 16])
@pytest.mark.parametrize("pack", list(XT_PACKS))
def test_build_xt_multi_is_stacked_build_xt(pack, F):
    """The feature-innermost XT, element for element: XT[..., f] is
    build_xt of column f, and the features up to Fp (F rounded up to a
    multiple of 4) are zero."""
    kw, n_parts = XT_PACKS[pack]
    cfg = hp.SpmvConfig(**kw)
    X = torch.from_numpy(np.random.default_rng(F).standard_normal(
        (n_parts * cfg.vb_cols - 37, F)).astype(np.float32))
    xt = build_xt_multi(X, cfg, n_parts)
    Fp = -(-F // 4) * 4
    assert xt.shape == (n_parts, cfg.total_blocks, 128, 128, Fp)
    assert xt.dtype == torch.float32 and xt.is_contiguous()
    stacked = torch.stack([build_xt(X[:, f], cfg, n_parts)
                           for f in range(F)], dim=-1)
    torch.testing.assert_close(xt[..., :F], stacked, rtol=0, atol=0)
    assert (xt[..., F:] == 0).all()
