"""The port's packed-stream SpMM against the JAX package's on the CPU.

The chain, block-major steal, multi-partition and column-order cases of
tests/test_spmm.py go through ``hisparse_tpu.SpmvOperator.matmul`` in
interpret mode and through the port's ``SpmvOperator(device="cpu")
.matmul``, whose kernel wrapper runs the plain PyTorch version
``spmm_tiles_plain`` on CPU tensors.  Tolerances, as
max|d| / max(max|ref|, 1):

  * 1e-6 against the interpret-mode reference, natural and renamed order:
    only the order of fp32 sums may differ (hub-split recombine, stripe
    fold);
  * bit-equal, within the port, between a feature of the SpMM and the
    SpMV of that column, and between chunkings of the features: each
    feature sums its terms in stream order.
"""
import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (SPMM_MAX_F, build_xt_multi,
                                         spmm_tiles_plain, wavepack_spmm)

TOL_REF = 1e-6

CHAIN = dict(sublanes=128, bank_blocks=1, stripes=128)
BM = dict(sublanes=128, bank_blocks=2, stripes=128, block_major=True,
          classes_per_group=2, steal_mantissa=True, two_choice=False)
MULTIPART = dict(sublanes=128, bank_blocks=1, stripes=32)

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
}


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
    assert _err(Y, ref) <= (5e-4 if op.cfg.steal_mantissa else 1e-4)
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


def test_spmm_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; on a device without a kernel it raises."""
    _, _, op, X = _case("chain")
    xt = build_xt_multi(torch.from_numpy(X), op.cfg, op.wp.n_parts)
    args = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
            op.run_end, xt, op.cfg)
    before = _kernels.spmm_launches
    acc = wavepack_spmm(*args)
    assert _kernels.spmm_launches == before
    assert acc.shape == (X.shape[1], op.wp.n_blocks * op.cfg.sublanes, 128)
    torch.testing.assert_close(acc, spmm_tiles_plain(*args), rtol=0, atol=0)
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
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        dtype="bf16")
    with pytest.raises(NotImplementedError):
        hp.spmm(hp.pack(m, cfg), np.zeros((m.num_cols, 2), np.float32),
                device="cpu")
