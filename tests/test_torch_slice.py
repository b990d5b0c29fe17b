"""The port's main path as a whole, at a small size, against the JAX
package on the CPU.

A googleplus-shaped power-law matrix (the suite entry is
powerlaw_csr(108000, 108000, 127, 1.2, seed=11)), cut to 4000 rows with
40 nonzeros a row, is packed at the suite's tuned design point for that
entry (bench_tuned.json) with the tile cut to sublanes=256, stripes=128:
block-major with 2 classes a group, steal_mantissa, idx16, split_max=64,
a degree column order, bm_win=bm_adv=1.  Both packages pack it; y goes
through ``hisparse_tpu.SpmvOperator`` in interpret mode and through
``hisparse_tpu_torch.SpmvOperator(device="cpu")``.  Tolerances as in
tests/test_torch_spmv.py: 1e-6 against the interpret-mode reference, 1e-4
against ``spmv_f64``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.golden import spmv_f64

CFG = dict(sublanes=256, bank_blocks=8, stripes=128, block_major=True,
           classes_per_group=2, steal_mantissa=True, idx16=True,
           two_choice=False)
PACK = dict(split_max=64, col_order="degree", bm_win=1, bm_adv=1)


@functools.lru_cache(maxsize=None)
def slice_case():
    m_r = ht.powerlaw_csr(4000, 4000, 40, 1.2, seed=11)
    m_p = hp.powerlaw_csr(4000, 4000, 40, 1.2, seed=11)
    wr = ht.pack(m_r, ht.SpmvConfig(**CFG), **PACK)
    wp = hp.pack(m_p, hp.SpmvConfig(**CFG), **PACK)
    x = np.random.default_rng(0).random(m_p.num_cols).astype(np.float32)
    op_r = ht.SpmvOperator(wr, interpret=True)
    return m_r, wr, wp, x, op_r(x), np.asarray(op_r(x, renamed=True))


def _err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1.0)


@pytest.mark.parametrize("source", ["port_pack", "npz", "from_arrays"])
def test_slice_matches_reference(source, tmp_path):
    """pack -> SpmvOperator -> natural-order y, with the pack made by the
    port, or made by the JAX package and carried over."""
    m_r, wr, wp, x, y_ref, y_ref_renamed = slice_case()
    if source == "npz":
        ht.save_wavepack(tmp_path / "slice.npz", wr)
        wp = hp.load_wavepack(tmp_path / "slice.npz")
    elif source == "from_arrays":
        wp = hp.wavepack_from_arrays(**vars(wr))
    assert dataclasses.asdict(wp.config) == CFG | dict(dtype="fp32",
                                                       semiring="plus_times")
    assert wp.num_tiles == wr.num_tiles and wp.nnz == m_r.nnz
    op = hp.SpmvOperator(wp, device="cpu")
    y = op(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (m_r.num_rows,)
    assert torch.isfinite(y).all()
    assert _err(y, y_ref) <= 1e-6
    assert _err(y, spmv_f64(m_r, x)) <= 1e-4
    y_renamed = op(torch.from_numpy(x), renamed=True)
    assert _err(y_renamed, y_ref_renamed) <= 1e-6
