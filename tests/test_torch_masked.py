"""The port's masked (SpMSpV-analog) SpMV against its full SpMV and the
JAX package's masked call on the CPU: the cases of tests/test_masked.py.

The port selects tiles (``SpmvOperator.active_tiles``) where the JAX
package selects groups of ``tb`` tiles; a skipped tile holds only columns
where x is the semiring's annihilator, so its terms are exact identities
and natural-order results agree.  Tolerances:

  * masked == full within the port, bit for bit, natural order (the
    fold adds a split row's partials in one fixed order);
  * against the JAX ``masked`` in natural order: min_plus and max_times
    bit for bit (one rounding per term, exact min and max), plus_times
    within 1e-6, max|dy| / max(max|y|, 1) (the order of fp32 sums).
    Renamed order may differ for max_times in blocks no selected tile
    reaches (-inf in the port, 0 where JAX streamed a pad tile of the
    group), so natural order is compared.
"""
import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (spmv_masked_tiles_plain,
                                         wavepack_spmv_masked)
from hisparse_tpu_torch.utils.bench import sparse_x

TOL_REF = 1e-6

# tests/test_masked.py:21-26
CONFIGS = {
    "chain": dict(bank_blocks=2, two_choice=False),
    "chain-tc": dict(bank_blocks=2, two_choice=True),
    "bm-k2-steal": dict(bank_blocks=2, block_major=True, classes_per_group=2,
                        two_choice=False, steal_mantissa=True),
}


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _ops(kw, m_args, seed, **pack_kw):
    m_r, m_p = ht.powerlaw_csr(*m_args, seed=seed), hp.powerlaw_csr(
        *m_args, seed=seed)
    op_r = ht.SpmvOperator(ht.pack(m_r, ht.SpmvConfig(**kw), **pack_kw),
                           interpret=True)
    op = hp.SpmvOperator(hp.pack(m_p, hp.SpmvConfig(**kw), **pack_kw),
                         device="cpu")
    return m_p, op_r, op


@pytest.mark.parametrize("name", list(CONFIGS))
def test_masked_matches_full(name):
    kw = dict(sublanes=128, stripes=128, **CONFIGS[name])
    m, op_r, op = _ops(kw, (3000, 40000, 6), 4, split_max=16,
                       col_order="degree")
    x, act = sparse_x(m.num_cols, 40, "plus_times")
    xt = torch.from_numpy(x)
    y_full = op(xt)
    y_masked = op.masked(xt, act)
    torch.testing.assert_close(y_masked, y_full, rtol=0, atol=0)
    # the boolean-mask form of ``active``, as a numpy array and a tensor
    torch.testing.assert_close(op.masked(xt, x > 0), y_full, rtol=0, atol=0)
    torch.testing.assert_close(op.masked(xt, xt > 0), y_full, rtol=0, atol=0)
    assert _err(y_masked, np.asarray(op_r.masked(x, act))) <= TOL_REF


def test_masked_paged_variant():
    """The JAX paged masked kernel (``_paged_masked_kernel``) and the
    port's masked call on one pack."""
    kw = dict(sublanes=128, bank_blocks=2, stripes=128, two_choice=False)
    m_r = ht.powerlaw_csr(3000, 40000, 6, seed=5)
    m_p = hp.powerlaw_csr(3000, 40000, 6, seed=5)
    op_r = ht.SpmvOperator(ht.pack(m_r, ht.SpmvConfig(**kw), split_max=16,
                                   col_order="degree"),
                           interpret=True, variant="paged")
    op = hp.SpmvOperator(hp.pack(m_p, hp.SpmvConfig(**kw), split_max=16,
                                 col_order="degree"), device="cpu")
    x, act = sparse_x(m_p.num_cols, 30, "plus_times", seed=1)
    y = op.masked(torch.from_numpy(x), act)
    torch.testing.assert_close(y, op(torch.from_numpy(x)), rtol=0, atol=0)
    assert _err(y, np.asarray(op_r.masked(x, act))) <= TOL_REF


def test_masked_skips_tiles():
    """Selectivity: one active column leaves most tiles of a
    many-partition pack unstreamed."""
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        two_choice=False)
    m = hp.powerlaw_csr(2000, 64 * 16384, 3, seed=6)
    op = hp.SpmvOperator(hp.pack(m, cfg, split_max=16), device="cpu")
    tiles = op.active_tiles(np.array([5]))
    assert 0 < len(tiles) < op.wp.num_tiles
    assert (np.asarray(op.wp.tile_part)[tiles] == 0).all()
    x = np.zeros(m.num_cols, np.float32)
    x[5] = 2.0
    torch.testing.assert_close(op.masked(torch.from_numpy(x), [5]),
                               op(torch.from_numpy(x)), rtol=0, atol=0)


@pytest.mark.parametrize("sr", ["min_plus", "max_times"])
def test_masked_semiring_matches_reference(sr):
    """min_plus with +inf (its annihilator) off the frontier, max_times with
    0: masked == full within the port and == the JAX ``masked``, bit for
    bit, in natural order."""
    kw = dict(sublanes=128, bank_blocks=2, stripes=128, two_choice=False,
              semiring=sr)
    m, op_r, op = _ops(kw, (2500, 30000, 5), 7, split_max=16)
    x, act = sparse_x(m.num_cols, 25, sr, seed=2)
    y = op.masked(torch.from_numpy(x), act)
    torch.testing.assert_close(y, op(torch.from_numpy(x)), rtol=0, atol=0)
    np.testing.assert_array_equal(y.numpy(), np.asarray(op_r.masked(x, act)))


def test_block_major_selection_follows_the_class_map():
    """A block-major tile is selected when one of its groups' (partition,
    class) pairs holds an active column: activating columns of one class
    selects exactly the tiles whose class map names it."""
    kw = dict(sublanes=128, stripes=128, **CONFIGS["bm-k2-steal"])
    m = hp.powerlaw_csr(3000, 40000, 6, seed=4)
    op = hp.SpmvOperator(hp.pack(m, hp.SpmvConfig(**kw), split_max=16),
                         device="cpu")
    cfg, wp = op.cfg, op.wp
    cls = 1
    cols = np.arange(cls * 128 * 128, cls * 128 * 128 + 50)   # partition 0
    expect = ((np.asarray(wp.tile_part) == 0)
              & (wp.class_map == cls).reshape(wp.num_tiles, -1).any(1))
    np.testing.assert_array_equal(op.active_tiles(cols),
                                  np.flatnonzero(expect))
    assert cfg.block_major and not cfg.two_choice


def test_masked_wrapper_on_cpu():
    """On CPU tensors the masked wrapper runs the plain version and
    launches nothing; on a device without a kernel it raises."""
    kw = dict(sublanes=128, stripes=128, **CONFIGS["chain"])
    m = hp.powerlaw_csr(600, 40000, 6, seed=4)
    op = hp.SpmvOperator(hp.pack(m, hp.SpmvConfig(**kw), split_max=16),
                         device="cpu")
    x, act = sparse_x(m.num_cols, 10, "plus_times")
    args = op.masked_args(torch.from_numpy(x), op.active_tiles(act)) + (
        op.cfg,)
    before = _kernels.masked_launches
    acc = wavepack_spmv_masked(*args)
    assert _kernels.masked_launches == before
    torch.testing.assert_close(acc, spmv_masked_tiles_plain(*args), rtol=0,
                               atol=0)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="no wavepack_spmv_masked kernel"):
        wavepack_spmv_masked(*meta)
    # the kernel trusts its tile ids: the operator checks them on the host
    for bad in ([1, 0], [-1], [op.wp.num_tiles]):
        with pytest.raises(ValueError, match="ascending"):
            op.masked_tiles(torch.from_numpy(x), bad)
