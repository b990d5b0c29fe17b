"""The port's SpMV against the JAX package's on the CPU.

The same pack and the same numpy-seeded x go through the JAX
``SpmvOperator`` in interpret mode (as tests/test_spmv.py runs it) and
through the port's ``SpmvOperator(device="cpu")``, whose kernel wrapper
runs the plain PyTorch version on CPU tensors.  Tolerances, as
max|dy| / max(max|y|, 1):

  * 1e-6 against the interpret-mode reference: both decode the stream the
    same way (masked decode, exact transpose), so only the order of fp32
    sums may differ (hub-split recombine, stripe fold);
  * 1e-4 against the f64 golden ``spmv_f64`` (the suite's gate), 8e-3 for
    bf16 values (one bf16 rounding a term, tests/test_formats.py:433);
  * Q8.24 packs bit for bit against the reference and ``golden.spmv_fixed``
    (saturating unsigned terms sum alike in any order).

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
from hisparse_tpu.ops import golden
from hisparse_tpu.ops.golden import spmv_f64
from hisparse_tpu_torch.config import LANES
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (block_runs, spmv_tiles_plain,
                                         wavepack_spmv)
from hisparse_tpu_torch.utils.bench import (MULTIBLOCK_FAMILY,
                                           PLUS_TIMES_FAMILIES, family_case,
                                           family_inputs)

TOL_REF = 1e-6
TOL_F64 = 1e-4

def _err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1.0)


def _case(fam):
    """(reference matrix, reference pack, port pack, x, JAX variant): the
    port's from ``utils/bench.family_case``, the reference's made as
    scripts/tpu_check.py makes it (Q8.24 words for the fixed family)."""
    args, split, xseed = family_inputs(fam)
    m_r = ht.powerlaw_csr(*args)
    if fam[1].get("dtype") == "fixed":
        m_r = dataclasses.replace(m_r, data=golden.float_to_fixed(
            np.abs(m_r.data) / (4 * 9)))
    wr = ht.pack(m_r, ht.SpmvConfig(**fam[1]), split_max=split)
    m_p, wp, x = family_case(fam)
    np.testing.assert_array_equal(m_p.data, m_r.data)
    return m_r, wr, wp, x, fam[3]


@pytest.mark.parametrize("fam", PLUS_TIMES_FAMILIES + (MULTIBLOCK_FAMILY,),
                         ids=lambda f: f[0])
def test_family_matches_reference(fam):
    m_r, wr, wp, x, variant = _case(fam)
    y_ref = np.asarray(ht.SpmvOperator(wr, interpret=True,
                                       variant=variant)(x))
    y = hp.SpmvOperator(wp, device="cpu")(torch.from_numpy(x))
    assert y.shape == (m_r.num_rows,)
    if wp.config.dtype == "fixed":
        np.testing.assert_array_equal(y.numpy(), y_ref)
        np.testing.assert_array_equal(y.numpy(),
                                      golden.spmv_fixed(m_r, x, m_r.data))
        return
    assert torch.isfinite(y).all()
    assert _err(y, y_ref) <= TOL_REF
    tol = 8e-3 if wp.config.dtype == "bf16" else TOL_F64
    assert _err(y, spmv_f64(m_r, x)) <= tol


def test_unpack_device_matches_unpack_y():
    """The device unpack (the fixed-order fold) equals the host recombine
    bit for bit, hub splits and padding rows included."""
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                        two_choice=False)
    m = hp.powerlaw_csr(700, 900, 8, alpha=1.1, seed=9)
    wp = hp.pack(m, cfg, split_max=8)          # tight split: duplicates
    assert np.unique(wp.perm[wp.perm < m.num_rows]).size < (
        (wp.perm < m.num_rows).sum())
    op = hp.SpmvOperator(wp, device="cpu")
    x = np.random.default_rng(0).random(m.num_cols).astype(np.float32)
    yr = op(torch.from_numpy(x), renamed=True)
    np.testing.assert_array_equal(op.unpack_device(yr).numpy(),
                                  wp.unpack_y(yr.numpy()))


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


CONFIG_KINDS = {
    "bf16": dict(dtype="bf16"),
    "min_plus": dict(semiring="min_plus", two_choice=False),
    "max_times": dict(semiring="max_times", two_choice=False),
    "fixed": dict(dtype="fixed", two_choice=False),
}


@pytest.mark.parametrize("kind", list(CONFIG_KINDS))
def test_unsupported_configs_raise(kind):
    """The pack kinds that raised until their slice now run and match the
    JAX operator: min_plus and max_times bit for bit (one rounding per
    term, exact min and max), bf16 within 1e-6 (fp32 sums in another
    order), Q8.24 bit for bit and equal to ``golden.spmv_fixed``.  Q8.24
    packs still refuse SpMM, the masked call and the device unpack with
    ``ValueError``, as the JAX package does."""
    kw = dict(sublanes=128, bank_blocks=2, stripes=64, **CONFIG_KINDS[kind])
    m_r = ht.powerlaw_csr(300, 400, 5, seed=2)
    m = hp.powerlaw_csr(300, 400, 5, seed=2)
    x = np.random.default_rng(2).random(m.num_cols).astype(np.float32)
    if kind == "fixed":
        data = golden.float_to_fixed(m.data / 8)
        m_r = dataclasses.replace(m_r, data=data)
        m = dataclasses.replace(m, data=data.copy())
        x = golden.float_to_fixed(x)
    wr = ht.pack(m_r, ht.SpmvConfig(**kw))
    op = hp.SpmvOperator(hp.pack(m, hp.SpmvConfig(**kw)), device="cpu")
    y = op(torch.from_numpy(x)).numpy()
    y_ref = np.asarray(ht.SpmvOperator(wr, interpret=True)(x))
    if kind == "bf16":
        assert _err(y, y_ref) <= TOL_REF
        return
    np.testing.assert_array_equal(y, y_ref)
    if kind != "fixed":
        return
    np.testing.assert_array_equal(y, golden.spmv_fixed(m_r, x, m_r.data))
    X = np.zeros((m.num_cols, 2), np.float32)
    for call in (lambda: op.matmul(X), lambda: op.masked(x, [0, 1]),
                 lambda: op.unpack_device(op(x, renamed=True))):
        with pytest.raises(ValueError):
            call()


# tests/test_fixed.py's cases: (matrix generator and args, values (None:
# the generator's, scaled by 1/num_cols as sw/host.cpp:480), x scale and
# shift, split_max, config, x seed)
FIXED_CASES = {
    "uniform": (("uniform_sparse_csr", (200, 300, 6), 2), None, 1.0, 0.0,
                None, dict(stripes=128), 0),
    "stripes": (("powerlaw_csr", (150, 200, 5), 3), None, 1.0, 0.0, None,
                dict(stripes=32), 0),
    "single-saturation": (("uniform_sparse_csr", (8, 8, 1), 4), 200.0, 1.0,
                          0.0, None, dict(stripes=128), 5),
    "multi-saturation": (("uniform_sparse_csr", (64, 96, 8), 9), 120.0, 1.0,
                         0.0, None, dict(stripes=128), 10),
    "saturating-products-hub-split": (
        ("uniform_sparse_csr", (48, 64, 8), 11), 50.0, 100.0, 100.0, 4,
        dict(stripes=128), 12),
}


@pytest.mark.parametrize("case", list(FIXED_CASES))
def test_fixed_matches_reference_and_golden(case):
    """Q8.24 SpMV bit for bit against the JAX operator in interpret mode and
    ``golden.spmv_fixed`` on tests/test_fixed.py's cases: saturating
    accumulations, saturating products and hub-split rows recombined on
    the host with saturation."""
    (gen, args, seed), val, x_scale, x_shift, split, cfg_kw, xseed = \
        FIXED_CASES[case]
    kw = dict(sublanes=128, bank_blocks=1, dtype="fixed", **cfg_kw)
    m = getattr(hp, gen)(*args, seed=seed)
    data = (np.full(m.nnz, val, np.float32) if val is not None
            else (m.data / m.num_cols).astype(np.float32))
    data_raw = golden.float_to_fixed(data)
    x = golden.float_to_fixed(np.random.default_rng(xseed).random(
        m.num_cols) * x_scale + x_shift)
    m_r = dataclasses.replace(getattr(ht, gen)(*args, seed=seed),
                              data=data_raw)
    wp = hp.pack(dataclasses.replace(m, data=data_raw.copy()),
                 hp.SpmvConfig(**kw), split_max=split)
    if split == 4:
        assert (np.bincount(wp.perm[wp.perm < m.num_rows]) > 1).any()
    y = hp.SpmvOperator(wp, device="cpu")(x).numpy()
    y_ref = np.asarray(ht.SpmvOperator(
        ht.pack(m_r, ht.SpmvConfig(**kw), split_max=split),
        interpret=True)(x))
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(y, golden.spmv_fixed(m_r, x, data_raw))


def test_block_runs_rejects_split_block():
    with pytest.raises(ValueError, match="contiguous"):
        block_runs(np.array([0, 0, 1, 0], np.int32), 2)
    start, end = block_runs(np.array([1, 1, 0, 2], np.int32), 4)
    assert start.tolist() == [2, 0, 3, 0] and end.tolist() == [3, 2, 4, 0]


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; on a device without a kernel it raises."""
    _, _, wp, x, _ = _case(PLUS_TIMES_FAMILIES[0])
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
