"""The port's SpMV against the JAX package's on the CPU.

The same pack and the same numpy-seeded x go through the JAX
``SpmvOperator`` in interpret mode (as tests/test_spmv.py runs it) and
through the port's ``SpmvOperator(device="cpu")``, whose kernel wrapper
runs the plain PyTorch version on CPU tensors.  Tolerances, as
max|dy| / max(max|y|, 1):

  * 1e-6 against the interpret-mode reference: both decode the stream the
    same way (masked decode, exact transpose), so only the order of fp32
    sums may differ (hub-split recombine, stripe fold);
  * 1e-4 against the f64 golden ``spmv_f64`` (the suite's gate).

The CUDA kernel itself runs only on a GPU; its tests are in
tests/test_torch_cuda.py, which imports no JAX, so that they also run on a
machine that has a GPU and no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.golden import spmv_f64
from hisparse_tpu_torch.config import LANES
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (block_runs, spmv_tiles_plain,
                                         wavepack_spmv)
from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES, MULTIBLOCK_FAMILY,
                                           family_inputs)

TOL_REF = 1e-6
TOL_F64 = 1e-4

def _err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1.0)


def _case(fam):
    """(reference matrix, reference pack, port pack, x, JAX variant)."""
    args, split, xseed = family_inputs(fam)
    m_r = ht.powerlaw_csr(*args)
    m_p = hp.powerlaw_csr(*args)
    wr = ht.pack(m_r, ht.SpmvConfig(**fam[1]), split_max=split)
    wp = hp.pack(m_p, hp.SpmvConfig(**fam[1]), split_max=split)
    x = np.random.default_rng(xseed).random(m_r.num_cols).astype(np.float32)
    return m_r, wr, wp, x, fam[3]


@pytest.mark.parametrize("fam", FP32_FAMILIES + (MULTIBLOCK_FAMILY,),
                         ids=lambda f: f[0])
def test_family_matches_reference(fam):
    m_r, wr, wp, x, variant = _case(fam)
    y_ref = np.asarray(ht.SpmvOperator(wr, interpret=True,
                                       variant=variant)(x))
    y = hp.SpmvOperator(wp, device="cpu")(torch.from_numpy(x))
    assert y.shape == (m_r.num_rows,) and torch.isfinite(y).all()
    assert _err(y, y_ref) <= TOL_REF
    assert _err(y, spmv_f64(m_r, x)) <= TOL_F64


def test_unpack_device_matches_unpack_y():
    """index_add_ over perm equals the host recombine, hub splits and
    padding rows included."""
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        two_choice=False)
    m = hp.powerlaw_csr(700, 900, 8, alpha=1.1, seed=9)
    wp = hp.pack(m, cfg, split_max=8)          # tight split: duplicates
    assert np.unique(wp.perm[wp.perm < m.num_rows]).size < (
        (wp.perm < m.num_rows).sum())
    op = hp.SpmvOperator(wp, device="cpu")
    x = np.random.default_rng(0).random(m.num_cols).astype(np.float32)
    yr = op(torch.from_numpy(x), renamed=True)
    np.testing.assert_allclose(op.unpack_device(yr).numpy(),
                               wp.unpack_y(yr.numpy()), atol=1e-6)


def test_empty_row_block():
    """A row block that receives no tiles comes out at 0."""
    kw = dict(sublanes=128, bank_blocks=1, stripes=128, two_choice=False)
    cfg = hp.SpmvConfig(**kw)
    rows = cfg.rows_per_block + 50             # 2 blocks
    args = (rows, 200, np.array([2.5, 1.0], np.float32),
            np.array([3, 7], np.int32),
            np.r_[0, 2, np.full(rows - 1, 2)].astype(np.int64))
    wp = hp.pack(hp.CSRMatrix(*args), cfg)
    wr = ht.pack(ht.CSRMatrix(*args), ht.SpmvConfig(**kw))
    start, end = block_runs(wp.tile_block, wp.n_blocks)
    assert wp.n_blocks == 2 and start[1] == end[1]
    x = np.arange(200, dtype=np.float32)
    y = hp.SpmvOperator(wp, device="cpu")(torch.from_numpy(x)).numpy()
    assert y[0] == pytest.approx(2.5 * x[3] + 1.0 * x[7])
    assert (y[1:] == 0).all()
    y_ref = np.asarray(ht.SpmvOperator(wr, interpret=True)(x))
    assert _err(y, y_ref) <= TOL_REF


def test_col_order_permutes_x():
    """pack(col_order='degree'): the operator takes natural-order x."""
    kw = dict(sublanes=128, bank_blocks=2, stripes=128, block_major=True,
              classes_per_group=2, steal_mantissa=True)
    m_r = ht.powerlaw_csr(600, 30000, 8, alpha=1.3, seed=31)
    m_p = hp.powerlaw_csr(600, 30000, 8, alpha=1.3, seed=31)
    wr = ht.pack(m_r, ht.SpmvConfig(**kw), split_max=16, col_order="degree")
    wp = hp.pack(m_p, hp.SpmvConfig(**kw), split_max=16, col_order="degree")
    x = np.random.default_rng(31).random(m_p.num_cols).astype(np.float32)
    y = hp.SpmvOperator(wp, device="cpu")(torch.from_numpy(x))
    y_ref = np.asarray(ht.SpmvOperator(wr, interpret=True)(x))
    assert _err(y, y_ref) <= TOL_REF
    assert _err(y, spmv_f64(m_p, x)) <= TOL_F64
    # without the permutation the operator must be fed packed-order x
    op_raw = hp.SpmvOperator(wp, device="cpu", permute_x=False)
    y_raw = op_raw(torch.from_numpy(x[wp.col_order]))
    assert _err(y_raw, y_ref) <= TOL_REF


UNSUPPORTED = {
    "bf16": dict(dtype="bf16"),
    "min_plus": dict(semiring="min_plus", two_choice=False),
    "max_times": dict(semiring="max_times", two_choice=False),
    "fixed": dict(dtype="fixed", two_choice=False),
}


@pytest.mark.parametrize("kind", list(UNSUPPORTED))
def test_unsupported_configs_raise(kind):
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=2, stripes=64,
                        **UNSUPPORTED[kind])
    m = hp.powerlaw_csr(300, 400, 5, seed=2)
    if kind == "fixed":
        m = dataclasses.replace(m, data=np.ones(m.nnz, np.uint32))
    wp = hp.pack(m, cfg)
    with pytest.raises(NotImplementedError):
        hp.SpmvOperator(wp, device="cpu")
    args = (torch.zeros(1, 128, 128), torch.zeros(1, 128, 128,
                                                  dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), None,
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), torch.zeros(1, 2, 128, 128))
    for fn in (wavepack_spmv, spmv_tiles_plain):
        with pytest.raises(NotImplementedError):
            fn(*args, cfg)


def test_block_runs_rejects_split_block():
    with pytest.raises(ValueError, match="contiguous"):
        block_runs(np.array([0, 0, 1, 0], np.int32), 2)
    start, end = block_runs(np.array([1, 1, 0, 2], np.int32), 4)
    assert start.tolist() == [2, 0, 3, 0] and end.tolist() == [3, 2, 4, 0]


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; on a device without a kernel it raises."""
    _, _, wp, x, _ = _case(FP32_FAMILIES[0])
    op = hp.SpmvOperator(wp, device="cpu")
    args = op.stream_args(torch.from_numpy(x))
    before = _kernels.launches
    acc = wavepack_spmv(*args, op.cfg)
    assert _kernels.launches == before
    torch.testing.assert_close(acc, spmv_tiles_plain(*args, op.cfg),
                               rtol=0, atol=0)
    meta = [a.to("meta") if a is not None else None for a in args]
    with pytest.raises(ValueError, match="no wavepack_spmv kernel"):
        wavepack_spmv(*meta, op.cfg)



DECODE_CASES = {
    "chain": dict(bank_blocks=2, two_choice=True),
    "chain-steal": dict(bank_blocks=2, two_choice=True, steal_mantissa=True),
    "chain-steal-idx16": dict(bank_blocks=2, two_choice=True,
                              steal_mantissa=True, idx16=True),
    "bm-k2": dict(bank_blocks=4, two_choice=False, block_major=True,
                  classes_per_group=2),
    "bm-k4-steal-tc": dict(bank_blocks=4, two_choice=True, block_major=True,
                           classes_per_group=4, steal_mantissa=True),
    "bm-k8-steal-idx16": dict(bank_blocks=8, two_choice=False,
                              block_major=True, classes_per_group=8,
                              steal_mantissa=True, idx16=True),
}


def random_tile(cfg, rng, n_parts=2):
    """One tile of arbitrary idx words (b-fields out of range included)
    and values, its class map and an XT of n_parts partitions."""
    S = cfg.sublanes
    h = rng.integers(0, 128, (S, LANES))
    b = rng.integers(0, 16, (S, LANES))
    if cfg.steal_mantissa:
        idx = (b << 7) | h
        v = rng.standard_normal((S, LANES)).astype(np.float32)
        src = rng.integers(0, 128, (S, LANES)).astype(np.uint32)
        v = ((v.view(np.uint32) & np.uint32(0xFFFFFF80)) | src).view(
            np.float32)
    else:
        idx = (rng.integers(0, 128, (S, LANES)) << 11) | (b << 7) | h
        v = rng.standard_normal((S, LANES)).astype(np.float32)
    idx = idx.astype(np.int16 if cfg.idx16 else np.int32)
    cmap = rng.integers(0, cfg.total_blocks,
                        (1, cfg.groups, cfg.classes_per_group)).astype(
                            np.int32)
    xt = rng.standard_normal((n_parts, cfg.total_blocks, 128, 128)).astype(
        np.float32)
    return v[None], idx[None], cmap, xt


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_plain_version_matches_tile_body(case):
    """The plain version's decode, banked gather, class select and
    crossbar against the JAX package's own per-tile body (``_tile_body``,
    interpret-mode decode) on one tile of arbitrary words."""
    import jax.numpy as jnp
    from hisparse_tpu.ops.spmv import _tile_body
    kw = dict(sublanes=256, stripes=128, **DECODE_CASES[case])
    cfg_r, cfg_p = ht.SpmvConfig(**kw), hp.SpmvConfig(**kw)
    v, idx, cmap, xt = random_tile(cfg_p, np.random.default_rng(7))
    part = 1
    if cfg_r.block_major:
        xt_arg = lambda c: jnp.asarray(xt[part])[c]
        cls_ids = [[int(c) for c in row] for row in cmap[0]]
    else:
        xt_arg, cls_ids = jnp.asarray(xt[part]), None
    ref = _tile_body(jnp.asarray(v[0]), jnp.asarray(idx[0]), xt_arg,
                     jnp.zeros((cfg_r.sublanes, LANES), jnp.float32), cfg_r,
                     cls_ids)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    got = spmv_tiles_plain(torch.from_numpy(v), torch.from_numpy(idx),
                           i32([part]), torch.from_numpy(cmap), i32([0]),
                           i32([1]), torch.from_numpy(xt), cfg_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
