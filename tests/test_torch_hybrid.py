"""The port's bulk + tail hybrid (``formats/wavepack.pack_hybrid``,
``ops/spmv.HybridSpmv``) against the JAX package's on the CPU.

``pack_hybrid`` is held byte-equal to the JAX one on the cases of
tests/test_spmv.py:153 and tests/test_formats.py:345, on a matrix whose
tail is not empty with each pack's own degree column order, and with
``stop_frac=0`` (an empty tail: one tile of padding).  ``HybridSpmv(device=
"cpu")`` runs the plain PyTorch versions of the SpMV kernel and the fold;
tolerances, as max|dy| / max(max|y|, 1): 1e-6 against the JAX operator in
interpret mode (natural and renamed y; the two sum a slot's terms in
another order), 1e-4 against the f64 golden.  Natural y is the fold of the
renamed sum, bit for bit ``Wavepack.unpack_y`` of it.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.formats.wavepack import pack_hybrid as ht_pack_hybrid
from hisparse_tpu.ops.golden import spmv_f64
from hisparse_tpu.ops.spmv import HybridSpmv as HtHybridSpmv
from hisparse_tpu_torch.formats.wavepack import decode, pack_hybrid
from hisparse_tpu_torch.ops.spmv import HybridSpmv, SpmvOperator
from test_torch_formats import assert_same_pack

TOL_REF = 1e-6
TOL_F64 = 1e-4

BM4_TC = dict(sublanes=128, bank_blocks=4, stripes=128, block_major=True,
              classes_per_group=2, two_choice=True)
# name: (SpmvConfig fields, powerlaw_csr args and keywords, pack_hybrid
# keywords)
CASES = {
    # tests/test_spmv.py:153 (its tail is empty)
    "spmv-stop0.3": (BM4_TC, ((2000, 30000, 8), dict(alpha=1.3, seed=5)),
                     dict(stop_frac=0.3)),
    # tests/test_formats.py:345: 2 row blocks x 2 column partitions, a
    # 13,676-tile tail
    "multisegment": (dict(sublanes=128, bank_blocks=1, stripes=128,
                          block_major=True, classes_per_group=2),
                     ((20000, 20000, 4), dict(alpha=1.3, seed=22)),
                     dict(split_max=None, stop_frac=0.5)),
    # bulk 20 tiles, tail 16, each pack its own column order
    "degree": (BM4_TC, ((4000, 60000, 16), dict(alpha=1.2, seed=5)),
               dict(split_max=32, col_order="degree")),
    # no stop: everything in the bulk, the tail one tile of padding
    "stop0": (BM4_TC, ((4000, 60000, 16), dict(alpha=1.2, seed=5)),
              dict(split_max=32, stop_frac=0.0)),
}
# the cases small enough for the JAX interpret-mode operator
OPERATOR_CASES = ("spmv-stop0.3", "degree", "stop0")


@functools.lru_cache(maxsize=None)
def packs(name):
    """(JAX matrix, JAX bulk and tail, port matrix, port bulk and tail)."""
    kw, (args, mkw), hkw = CASES[name]
    m_r = ht.powerlaw_csr(*args, **mkw)
    m_p = hp.powerlaw_csr(*args, **mkw)
    return (m_r, ht_pack_hybrid(m_r, ht.SpmvConfig(**kw), **hkw),
            m_p, pack_hybrid(m_p, hp.SpmvConfig(**kw), **hkw))


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("name", list(CASES))
def test_pack_hybrid_byte_equal(name):
    m_r, (rb, rt), m_p, (pb, pt) = packs(name)
    assert_same_pack(rb, pb)
    assert_same_pack(rt, pt)
    np.testing.assert_array_equal(pb.perm, pt.perm)
    if name != "multisegment":   # its tail's 224M slots decode slowly
        a = decode(pb).to_scipy() + decode(pt).to_scipy()
        assert np.abs((a - m_p.to_scipy()).toarray()).max() <= 1e-6
    if name == "stop0":
        assert (pt.num_tiles, pt.nnz, pt.fill) == (1, 0, 0.0)
    if name == "degree":
        assert pt.nnz > 0
        assert not np.array_equal(pb.col_order, pt.col_order)


@functools.lru_cache(maxsize=None)
def _jax_y(name):
    """The JAX operator's natural and renamed y in interpret mode."""
    m_r, (rb, rt), _, _ = packs(name)
    x = np.random.default_rng(5).random(m_r.num_cols).astype(np.float32)
    op = HtHybridSpmv(rb, rt, interpret=True)
    return (x, np.asarray(op(x)), np.asarray(op(x, renamed=True)), op.nnz,
            op.stream_bytes, op.fill)


@pytest.mark.parametrize("name", OPERATOR_CASES)
def test_hybrid_spmv_matches_jax(name):
    m_r, _, _, (pb, pt) = packs(name)
    x, y_ref, ren_ref, nnz, sb, fill = _jax_y(name)
    op = HybridSpmv(pb, pt, device="cpu")
    y = op(torch.from_numpy(x))
    ren = op(torch.from_numpy(x), renamed=True)
    assert y.shape == (m_r.num_rows,) and torch.isfinite(y).all()
    assert _err(y, y_ref) <= TOL_REF
    assert _err(y, spmv_f64(m_r, x)) <= TOL_F64
    assert _err(ren, ren_ref) <= TOL_REF
    assert (op.nnz, op.stream_bytes, op.fill) == (nnz, sb, fill)


def test_hybrid_folds_the_renamed_sum():
    """Natural y is the one fold of y_bulk + y_tail in renamed order,
    bit for bit ``Wavepack.unpack_y`` of it: folding each pack apart and
    adding in natural order gives other bits on this matrix, whose hub
    rows are split across both packs."""
    _, _, _, (pb, pt) = packs("degree")
    op = HybridSpmv(pb, pt, device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).random(
        pb.num_cols).astype(np.float32))
    y = op(x)
    np.testing.assert_array_equal(
        y.numpy(), pb.unpack_y(op(x, renamed=True).numpy()))
    assert not torch.equal(y, op.bulk(x) + op.tail(x))


def test_hybrid_permutes_x_per_pack():
    """Each operator permutes natural x by its own pack's column order:
    one x permuted by the bulk's order for both packs gives a wrong y."""
    m_r, _, _, (pb, pt) = packs("degree")
    x = np.random.default_rng(8).random(pb.num_cols).astype(np.float32)
    xs = torch.from_numpy(x)
    y = HybridSpmv(pb, pt, device="cpu")(xs)
    assert _err(y, spmv_f64(m_r, x)) <= TOL_F64
    ob = SpmvOperator(pb, "cpu", permute_x=False)
    ot = SpmvOperator(pt, "cpu", permute_x=False)
    xp = xs[torch.from_numpy(np.asarray(pb.col_order))]
    y_shared = ob.unpack_device(ob(xp, renamed=True) + ot(xp, renamed=True))
    assert _err(y_shared, spmv_f64(m_r, x)) > 10 * TOL_F64


@pytest.mark.parametrize("what", ["select-chain bulk", "bf16", "min_plus",
                                  "tail geometry"])
def test_pack_hybrid_rejects(what):
    m = hp.powerlaw_csr(2000, 30000, 8, alpha=1.3, seed=5)
    cfg = hp.SpmvConfig(**BM4_TC)
    tail = None
    if what == "select-chain bulk":
        cfg = dataclasses.replace(cfg, block_major=False)
    elif what == "bf16":
        cfg = dataclasses.replace(cfg, dtype="bf16")
    elif what == "min_plus":
        cfg = dataclasses.replace(cfg, semiring="min_plus")
    else:
        tail = dataclasses.replace(cfg, block_major=False, stripes=64)
    with pytest.raises(ValueError):
        pack_hybrid(m, cfg, tail)


def test_hybrid_spmv_rejects_other_geometry():
    """Packs of two matrices rename their rows apart."""
    _, _, _, (pb, _) = packs("spmv-stop0.3")
    _, _, _, (_, pt) = packs("degree")
    with pytest.raises(ValueError):
        HybridSpmv(pb, pt, device="cpu")
