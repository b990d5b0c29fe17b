"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false.  The file imports no JAX (the
GPU machine need not have it); run it there with the repository's
conftest, which imports JAX, left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as max|dy| / max(max|y|, 1): kernel against plain version
1e-6 (both sum each slot's terms in stream order, multiply and add rounded
separately, so only an FMA-free difference could show); natural-order y
against the f64 golden 1e-4 (the suite's gate).  The gradient stream is
one product per slot and is held bit for bit; on streams of arbitrary idx
words every kernel is held bit for bit.  min_plus and max_times round
once per term and take an exact min or max, so their kernels are held
bit for bit everywhere, NaN placement included, and the masked kernel
bit for bit against its plain version and against the full SpMV.  bf16
streams widen each value exactly and round each operation once, and
Q8.24 is integer arithmetic, so both are held bit for bit too.  The BCSR
kernel sums each output in another order than ``torch.bmm``: fp32 blocks
within 1e-5 of max|Y|, bf16 blocks on the tensor cores (whose fp32
accumulation is not IEEE-ordered) within 1e-4.
"""
import itertools

import numpy as np
import pytest
import torch

from hisparse_tpu_torch import SpmvOperator
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.golden import spmv_f64
from hisparse_tpu_torch.ops.golden import spmv_fixed_vec
from hisparse_tpu_torch.ops.spmv import (
    SPMM_MAX_F, build_xt, build_xt_multi, fixed_bits,
    gradstream_tiles_plain, spmm_tiles_plain, spmv_masked_tiles_plain,
    spmv_tiles_plain, wavepack_gradstream, wavepack_spmm, wavepack_spmv,
    wavepack_spmv_masked)
from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES, MULTIBLOCK_FAMILY,
                                           PLUS_TIMES_FAMILIES,
                                           SEMIRING_FAMILIES, family_case,
                                           semiring_f64, sparse_x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def _device_x(op, x, dev):
    """A family's x on the card in packed column order (Q8.24 words for a
    fixed-point pack)."""
    x_dev = (fixed_bits(x) if op.cfg.dtype == "fixed"
             else torch.from_numpy(x)).to(dev)
    return x_dev if op.col_order is None else x_dev[op.col_order]


@pytest.mark.cuda
@pytest.mark.parametrize("fam", PLUS_TIMES_FAMILIES + (MULTIBLOCK_FAMILY,),
                         ids=lambda f: f[0])
def test_kernel_matches_plain_on_cuda(fam, cuda_device):
    """Kernel vs plain version on the same CUDA operands (bf16 and Q8.24
    bit for bit); the launch counter rises by one per kernel call and the
    operator's y matches the golden: f64 within 1e-4 (8e-3 for bf16
    values, one bf16 rounding a term), ``spmv_fixed_vec`` exactly."""
    m, wp, x = family_case(fam)
    op = SpmvOperator(wp, device=cuda_device)
    args = op.stream_args(_device_x(op, x, cuda_device))
    before = _kernels.launches
    acc = wavepack_spmv(*args, op.cfg)
    torch.cuda.synchronize()
    assert _kernels.launches == before + 1
    plain = spmv_tiles_plain(*args, op.cfg)
    if op.cfg.dtype == "fp32":
        assert _err(op.renamed_y(acc), op.renamed_y(plain)) <= 1e-6
    else:
        _exact(acc, plain)
    y = op(x)
    assert y.shape == (m.num_rows,)
    if op.cfg.dtype == "fixed":
        np.testing.assert_array_equal(y.numpy(),
                                      spmv_fixed_vec(m, x, m.data))
        return
    assert y.device.type == "cuda"
    tol = 8e-3 if op.cfg.dtype == "bf16" else 1e-4
    assert _err(y, torch.from_numpy(spmv_f64(m, x))) <= tol


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda_device):
    """The wrapper checks dtype and shape before it launches."""
    m, wp, x = family_case(FP32_FAMILIES[0])
    op = SpmvOperator(wp, device=cuda_device)
    args = list(op.stream_args(torch.from_numpy(x).to(cuda_device)))
    args[1] = args[1].to(torch.int64)
    before = _kernels.launches
    with pytest.raises(ValueError):
        wavepack_spmv(*args, op.cfg)
    assert _kernels.launches == before


FUZZ_CASES = {
    "chain": dict(bank_blocks=2, two_choice=True),
    "chain-steal-idx16": dict(bank_blocks=2, two_choice=True,
                              steal_mantissa=True, idx16=True),
    "bm-k2": dict(bank_blocks=4, two_choice=False, block_major=True,
                  classes_per_group=2),
    "bm-k4-steal-tc": dict(bank_blocks=4, two_choice=True, block_major=True,
                           classes_per_group=4, steal_mantissa=True),
    "bm-k8-steal-idx16": dict(bank_blocks=8, two_choice=False,
                              block_major=True, classes_per_group=8,
                              steal_mantissa=True, idx16=True),
    "bm-k2-steal-tc-idx16": dict(bank_blocks=4, two_choice=True,
                                 block_major=True, classes_per_group=2,
                                 steal_mantissa=True, idx16=True),
}


def fuzz_stream(cfg, dev, runs=(2, 0, 4)):
    """Tiles of arbitrary idx words (b-fields out of range included) in
    row blocks of ``runs`` tiles each (by default 6 tiles over 3 blocks,
    the middle block empty), tiles spread over 2 column partitions:
    (vals, idxT, tile_part, cmap, run_start, run_end, tile_block) on dev,
    and a numpy generator for more operands."""
    rng = np.random.default_rng(11)
    T, S, n_parts = sum(runs), cfg.sublanes, 2
    h = rng.integers(0, 128, (T, S, 128))
    b = rng.integers(0, 16, (T, S, 128))
    v = rng.standard_normal((T, S, 128)).astype(np.float32)
    if cfg.steal_mantissa:
        idx = (b << 7) | h
        src = rng.integers(0, 128, (T, S, 128)).astype(np.uint32)
        v = ((v.view(np.uint32) & np.uint32(0xFFFFFF80)) | src).view(
            np.float32)
    else:
        idx = (rng.integers(0, 128, (T, S, 128)) << 11) | (b << 7) | h
    idx = idx.astype(np.int16 if cfg.idx16 else np.int32)
    cmap = rng.integers(0, cfg.total_blocks,
                        (T, cfg.groups, cfg.classes_per_group))

    def dev_(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    end = np.cumsum(runs)
    stream = (dev_(v), dev_(idx), dev_(rng.integers(0, n_parts, T), np.int32),
              dev_(cmap, np.int32) if cfg.block_major else None,
              dev_(end - np.asarray(runs), np.int32), dev_(end, np.int32),
              dev_(np.repeat(np.arange(len(runs)), runs), np.int32))
    return stream, rng, dev_


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUZZ_CASES))
def test_kernel_matches_plain_on_arbitrary_words(case, cuda_device):
    """Every kernel vs its plain version, bit for bit, on a stream of
    arbitrary idx words."""
    from hisparse_tpu_torch import SpmvConfig
    cfg = SpmvConfig(sublanes=256, stripes=128, **FUZZ_CASES[case])
    (v, idx, part, cmap, start, end, block), rng, dev = fuzz_stream(
        cfg, cuda_device)
    S = cfg.sublanes
    xt = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128)),
             np.float32)
    args = (v, idx, part, cmap, start, end, xt)
    acc = wavepack_spmv(*args, cfg)
    plain = spmv_tiles_plain(*args, cfg)
    torch.testing.assert_close(acc, plain, rtol=0, atol=0)
    assert (acc.reshape(3, S, 128)[1] == 0).all()

    xtm = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128, 8)),
              np.float32)
    args = (v, idx, part, cmap, start, end, xtm, cfg)
    accm = wavepack_spmm(*args, F=5)
    torch.testing.assert_close(accm, spmm_tiles_plain(*args, F=5), rtol=0,
                               atol=0)
    assert (accm.reshape(5, 3, S, 128)[:, 1] == 0).all()

    mask = dev(rng.random(v.shape) < 0.7, np.float32)
    g_acc = dev(rng.standard_normal((3 * S, 128)), np.float32)
    args = (v, idx, mask, part, block, cmap, g_acc, xt)
    out = wavepack_gradstream(*args, cfg)
    torch.testing.assert_close(out, gradstream_tiles_plain(*args, cfg),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", FP32_FAMILIES + (MULTIBLOCK_FAMILY,),
                         ids=lambda f: f[0])
def test_gradstream_and_spmm_match_plain_on_cuda(fam, cuda_device):
    """The gradient-stream kernel bit for bit and the SpMM kernel within
    1e-6 of their plain versions on the same CUDA operands, each launch
    counted once; SpMM at F in {1, 5, 16}, each feature equal to the
    SpMV kernel's y of its column."""
    m, wp, x = family_case(fam)
    op = SpmvOperator(wp, device=cuda_device, permute_x=False)
    rng = np.random.default_rng(17)
    S, cfg = op.cfg.sublanes, op.cfg
    mask = torch.from_numpy(
        (rng.random(op.vals.shape) < 0.8).astype(np.float32)).to(cuda_device)
    g_acc = torch.from_numpy(rng.standard_normal(
        (wp.n_blocks * S, 128)).astype(np.float32)).to(cuda_device)
    xt = build_xt(torch.from_numpy(x).to(cuda_device), cfg, wp.n_parts)
    args = (op.vals, op.idxT, mask, op.tile_part, op.tile_block,
            op.class_map, g_acc, xt, cfg)
    before = _kernels.gradstream_launches
    out = wavepack_gradstream(*args)
    torch.cuda.synchronize()
    assert _kernels.gradstream_launches == before + 1
    torch.testing.assert_close(out, gradstream_tiles_plain(*args), rtol=0,
                               atol=0)
    for F in (1, 5, SPMM_MAX_F):
        X = torch.from_numpy(rng.standard_normal(
            (wp.num_cols, F)).astype(np.float32)).to(cuda_device)
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(X, cfg, wp.n_parts), cfg)
        before = _kernels.spmm_launches
        acc = wavepack_spmm(*sargs, F=F)
        torch.cuda.synchronize()
        assert _kernels.spmm_launches == before + 1
        assert acc.shape == (F, wp.n_blocks * S, 128)
        assert _err(acc, spmm_tiles_plain(*sargs, F=F)) <= 1e-6
        y_ren = op.matmul(X, renamed=True)
        assert _err(y_ren[F - 1], op(X[:, F - 1], renamed=True)) <= 1e-6


@pytest.mark.cuda
def test_new_kernels_reject_bad_operands(cuda_device):
    """The gradient-stream and SpMM wrappers check dtype and shape, and
    SpMM's feature count, before they launch."""
    m, wp, x = family_case(FP32_FAMILIES[0])
    op = SpmvOperator(wp, device=cuda_device)
    S = op.cfg.sublanes
    xt = build_xt(torch.from_numpy(x).to(cuda_device), op.cfg, wp.n_parts)
    g_acc = torch.zeros(wp.n_blocks * S, 128, device=cuda_device)
    mask = torch.ones_like(op.vals)
    before = _kernels.gradstream_launches
    for bad in (mask.to(torch.float64), mask[:, :, :64]):
        with pytest.raises(ValueError):
            wavepack_gradstream(op.vals, op.idxT, bad, op.tile_part,
                                op.tile_block, op.class_map, g_acc, xt,
                                op.cfg)
    assert _kernels.gradstream_launches == before
    before = _kernels.spmm_launches
    X = torch.zeros(wp.num_cols, SPMM_MAX_F + 1, device=cuda_device)
    with pytest.raises(ValueError):
        wavepack_spmm(op.vals, op.idxT, op.tile_part, op.class_map,
                      op.run_start, op.run_end,
                      build_xt_multi(X, op.cfg, wp.n_parts), op.cfg)
    with pytest.raises(ValueError):
        wavepack_spmm(op.vals, op.idxT.to(torch.int64), op.tile_part,
                      op.class_map, op.run_start, op.run_end,
                      build_xt_multi(X[:, :2], op.cfg, wp.n_parts), op.cfg)
    assert _kernels.spmm_launches == before


@pytest.mark.cuda
def test_queued_timing_keeps_host_out(cuda_device):
    """``device_time_ms(queued=True)`` times a kernel launch without its
    host enqueue, and raises when the timed call synchronises, since the
    device then waits for the host."""
    from hisparse_tpu_torch.utils.bench import device_time_ms
    m, wp, x = family_case(FP32_FAMILIES[0])
    op = SpmvOperator(wp, device=cuda_device)
    x_dev = torch.from_numpy(x).to(cuda_device)
    args = op.stream_args(x_dev if op.col_order is None
                          else x_dev[op.col_order])
    ms = device_time_ms(lambda: wavepack_spmv(*args, op.cfg), reps=10,
                        queued=True)
    assert 0.0 < ms < 1.0
    with pytest.raises(RuntimeError, match="ran dry"):
        device_time_ms(torch.cuda.synchronize, reps=3, queued=True)


@pytest.mark.cuda
def test_profile_breakdown_sees_the_kernel(cuda_device):
    """``profile_breakdown`` finds the SpMV kernel among the device ops of
    a forward, and its busy time and idle share are consistent with the
    forward's event time."""
    from hisparse_tpu_torch.utils.bench import profile_breakdown
    m, wp, x = family_case(FP32_FAMILIES[0])
    op = SpmvOperator(wp, device=cuda_device)
    x_dev = torch.from_numpy(x).to(cuda_device)
    prof = profile_breakdown(lambda: op(x_dev), steps=5)
    names = [name for _, _, name in prof["ops"]]
    assert any("wavepack_kernel" in name for name in names), names
    assert 0.0 < prof["busy_us"]
    assert 0.0 <= prof["idle_share"] < 1.0
    assert prof["ops"] == sorted(prof["ops"], reverse=True)


def _exact(a, b):
    """Bit for bit, NaN placement included."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", SEMIRING_FAMILIES, ids=lambda f: f[0])
def test_semiring_kernels_match_plain_on_cuda(fam, cuda_device):
    """min_plus and max_times: the SpMV kernel bit for bit against its
    plain version and within 1e-6 of the float64 oracle (finite rows; the
    same rows infinite), SpMM at F = 5 bit for bit, each launch counted."""
    m, wp, x = family_case(fam)
    sr = wp.config.semiring
    op = SpmvOperator(wp, device=cuda_device)
    args = op.stream_args(torch.from_numpy(x).to(cuda_device))
    before = _kernels.launches
    acc = wavepack_spmv(*args, op.cfg)
    torch.cuda.synchronize()
    assert _kernels.launches == before + 1
    _exact(acc, spmv_tiles_plain(*args, op.cfg))
    y = op(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    ref = semiring_f64(m, x, sr)
    fin = np.isfinite(ref)
    assert (np.isfinite(y) == fin).all()
    assert np.abs(y[fin] - ref[fin]).max() <= 1e-6 * max(
        np.abs(ref[fin]).max(), 1.0)
    X = torch.from_numpy(np.random.default_rng(5).random(
        (wp.num_cols, 5)).astype(np.float32)).to(cuda_device)
    sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
             op.run_end, build_xt_multi(X, op.cfg, wp.n_parts), op.cfg)
    before = _kernels.spmm_launches
    accm = wavepack_spmm(*sargs)
    torch.cuda.synchronize()
    assert _kernels.spmm_launches == before + 1
    _exact(accm, spmm_tiles_plain(*sargs))


def _semiring_cases():
    """(family, semiring) for every fp32 family and each semiring its
    config allows (min_plus refuses steal_mantissa)."""
    out = []
    for fam in FP32_FAMILIES + (MULTIBLOCK_FAMILY,):
        for sr in ("plus_times", "min_plus", "max_times"):
            if not (sr == "min_plus" and fam[1].get("steal_mantissa")):
                out.append((fam[0] + "/" + sr,
                            dict(fam[1], semiring=sr)) + fam[2:])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fam", _semiring_cases(), ids=lambda f: f[0])
def test_masked_kernel_matches_plain_and_full(fam, cuda_device):
    """The masked kernel bit for bit against its plain version, with 40
    active columns, and masked == full (natural order; renamed for
    plus_times); the masked counter rises by one per launch."""
    from hisparse_tpu_torch import pack, powerlaw_csr
    from hisparse_tpu_torch.config import SpmvConfig
    from hisparse_tpu_torch.utils.bench import family_inputs
    name, kw = fam[0], fam[1]
    args, split, _ = family_inputs((name.split("/")[0],) + fam[1:])
    m = powerlaw_csr(*args)
    wp = pack(m, SpmvConfig(**kw), split_max=split)
    op = SpmvOperator(wp, device=cuda_device)
    x, act = sparse_x(m.num_cols, 40, kw["semiring"], seed=3)
    x_dev = torch.from_numpy(x).to(cuda_device)
    margs = op.masked_args(x_dev, op.active_tiles(act)) + (op.cfg,)
    before = _kernels.masked_launches
    acc = wavepack_spmv_masked(*margs)
    torch.cuda.synchronize()
    assert _kernels.masked_launches == before + 1
    _exact(acc, spmv_masked_tiles_plain(*margs))
    # plus_times in renamed order: on CUDA index_add_ adds a split row's
    # partials in no fixed order
    renamed = kw["semiring"] == "plus_times"
    _exact(op.masked(x_dev, act, renamed=renamed), op(x_dev, renamed=renamed))


@pytest.mark.cuda
@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "max_times"])
def test_nan_lands_in_the_same_rows(sr, cuda_device):
    """A NaN in x reaches the same accumulator slots through the SpMV,
    SpMM and masked kernels as through their plain versions."""
    fam = next(f for f in SEMIRING_FAMILIES if f[0] == "chain-fp32/min_plus")
    from hisparse_tpu_torch import pack
    from hisparse_tpu_torch.config import SpmvConfig
    m, _, x = family_case(fam)
    wp = pack(m, SpmvConfig(**dict(fam[1], semiring=sr)), split_max=16)
    op = SpmvOperator(wp, device=cuda_device)
    x[m.indices[[0, m.nnz // 2]]] = np.nan    # two columns with entries
    x_dev = torch.from_numpy(x).to(cuda_device)
    args = op.stream_args(x_dev)
    acc = wavepack_spmv(*args, op.cfg)
    assert torch.isnan(acc).any()
    _exact(acc, spmv_tiles_plain(*args, op.cfg))
    xt = build_xt_multi(torch.stack([x_dev, x_dev.flip(0)], 1), op.cfg,
                        wp.n_parts)
    sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
             op.run_end, xt, op.cfg)
    _exact(wavepack_spmm(*sargs), spmm_tiles_plain(*sargs))
    margs = op.masked_args(x_dev, np.arange(wp.num_tiles)) + (op.cfg,)
    _exact(wavepack_spmv_masked(*margs), acc)
    _exact(spmv_masked_tiles_plain(*margs), acc)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUZZ_CASES))
@pytest.mark.parametrize("sr", ["min_plus", "max_times"])
def test_semiring_kernels_on_arbitrary_words(case, sr, cuda_device):
    """The SpMV, SpMM and masked kernels in min_plus and max_times, bit
    for bit against their plain versions on a stream of arbitrary idx
    words and signed values; the empty block comes out at the identity."""
    from hisparse_tpu_torch import SpmvConfig
    kw = dict(FUZZ_CASES[case], semiring=sr)
    if sr == "min_plus" and kw.get("steal_mantissa"):
        pytest.skip("min_plus packs never steal mantissa bits (config.py)")
    cfg = SpmvConfig(sublanes=256, stripes=128, **kw)
    (v, idx, part, cmap, start, end, block), rng, dev = fuzz_stream(
        cfg, cuda_device)
    S = cfg.sublanes
    ident = float("inf") if sr == "min_plus" else float("-inf")
    xt = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128)),
             np.float32)
    args = (v, idx, part, cmap, start, end, xt)
    acc = wavepack_spmv(*args, cfg)
    _exact(acc, spmv_tiles_plain(*args, cfg))
    assert (acc.reshape(3, S, 128)[1] == ident).all()
    xtm = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128, 8)),
              np.float32)
    args = (v, idx, part, cmap, start, end, xtm, cfg)
    _exact(wavepack_spmm(*args, F=5), spmm_tiles_plain(*args, F=5))
    # tiles 1, 3 and 5: block 0 keeps one, block 2 two
    margs = (v, idx, dev([1, 3, 5], np.int32), part, cmap,
             dev([0, 1, 1], np.int32), dev([1, 1, 3], np.int32), xt, cfg)
    _exact(wavepack_spmv_masked(*margs), spmv_masked_tiles_plain(*margs))


@pytest.mark.cuda
def test_bf16_spmm_and_masked_match_plain_on_cuda(cuda_device):
    """A bf16 stream through the SpMM kernel (F = 5 and 16) and the masked
    kernel, bit for bit against their plain versions; masked == full in
    renamed order."""
    fam = next(f for f in PLUS_TIMES_FAMILIES if f[0] == "bf16-stream")
    m, wp, x = family_case(fam)
    op = SpmvOperator(wp, device=cuda_device)
    assert op.vals.dtype == torch.bfloat16
    rng = np.random.default_rng(19)
    for F in (5, SPMM_MAX_F):
        X = torch.from_numpy(rng.standard_normal(
            (wp.num_cols, F)).astype(np.float32)).to(cuda_device)
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(X, op.cfg, wp.n_parts), op.cfg)
        _exact(wavepack_spmm(*sargs), spmm_tiles_plain(*sargs))
    xs, act = sparse_x(m.num_cols, 40, "plus_times", seed=3)
    x_dev = torch.from_numpy(xs).to(cuda_device)
    margs = op.masked_args(x_dev, op.active_tiles(act)) + (op.cfg,)
    before = _kernels.masked_launches
    acc = wavepack_spmv_masked(*margs)
    torch.cuda.synchronize()
    assert _kernels.masked_launches == before + 1
    _exact(acc, spmv_masked_tiles_plain(*margs))
    _exact(op.masked(x_dev, act, renamed=True), op(x_dev, renamed=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fixed"])
def test_value_types_on_arbitrary_words(dtype, cuda_device):
    """bf16 values of every magnitude and Q8.24 words over the whole
    uint32 range (most products and sums saturate) through the SpMV
    kernel, bit for bit against its plain version on a stream of arbitrary
    idx words; the empty block comes out at 0."""
    from hisparse_tpu_torch import SpmvConfig
    cfg = SpmvConfig(sublanes=256, stripes=128, bank_blocks=2,
                     two_choice=False, dtype=dtype)
    (v, idx, part, cmap, start, end, _), rng, dev = fuzz_stream(
        cfg, cuda_device)
    if dtype == "bf16":
        v = v.to(torch.bfloat16)
        xt = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128)),
                 np.float32)
    else:
        words = lambda shape: dev(rng.integers(0, 1 << 32, shape,
                                               dtype=np.uint64)
                                  .astype(np.uint32).view(np.int32))
        v = words(tuple(v.shape))
        xt = words((2, cfg.total_blocks, 128, 128))
    args = (v, idx, part, cmap, start, end, xt)
    acc = wavepack_spmv(*args, cfg)
    _exact(acc, spmv_tiles_plain(*args, cfg))
    assert (acc.reshape(3, cfg.sublanes, 128)[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 64, 72])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bcsr_kernel_matches_plain_on_cuda(dtype, k, cuda_device):
    """The BCSR kernel against its plain version on a block-structured
    matrix with empty block rows, each launch counted once; the
    operator's Y against a float64 product of the operands it rounds."""
    from hisparse_tpu_torch import (BcsrOperator, CSRMatrix,
                                    block_structured_csr)
    from hisparse_tpu_torch.ops.bcsr import bcsr_plain, bcsr_spmm
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    m = block_structured_csr(1024, 768, block_rows=3, seed=5)
    keep = m.to_scipy().tocsr()
    keep[256:512] = 0                  # block rows 2 and 3 without blocks
    keep.eliminate_zeros()
    m = CSRMatrix.from_scipy(keep)
    op = BcsrOperator(m, tdt, device=cuda_device)
    X = torch.from_numpy(np.random.default_rng(k).random(
        (m.num_cols, k)).astype(np.float32)).to(cuda_device)
    xp = op.padded_x(X)
    before = _kernels.bcsr_launches
    out = bcsr_spmm(op.blocks, op.brow_ptr, op.bcol, xp)
    torch.cuda.synchronize()
    assert _kernels.bcsr_launches == before + 1
    plain = bcsr_plain(op.blocks, op.brow_ptr, op.bcol, xp)
    tol = 1e-5 if dtype == "fp32" else 1e-4
    assert float((out - plain).abs().max()) <= tol * float(
        plain.abs().max())
    assert (out[256:512] == 0).all()
    Y = op(X)
    assert Y.shape == (m.num_rows, k) and Y.dtype == torch.float32
    a = m.to_scipy().tocsr()
    a.sum_duplicates()
    a.data = torch.from_numpy(a.data.astype(np.float32)).to(tdt).double(
        ).numpy()
    ref = a @ X.to(tdt).double().cpu().numpy()
    assert np.abs(Y.double().cpu().numpy() - ref).max() <= tol * np.abs(
        ref).max()


def _algebra_cfg(alg, case):
    """An SpmvConfig of FUZZ_CASES[case] in algebra ``alg``: a semiring,
    or "bf16" (plus_times over bf16 values)."""
    from hisparse_tpu_torch import SpmvConfig
    kw = dict(FUZZ_CASES[case])
    if alg == "bf16":
        kw["dtype"] = "bf16"
    else:
        kw["semiring"] = alg
    return SpmvConfig(sublanes=256, stripes=128, **kw)


# each algebra on a pack it allows: min_plus and bf16 never steal
ALGEBRA_CASES = {"plus_times": "bm-k2-steal-tc-idx16",
                 "max_times": "chain-steal-idx16", "min_plus": "bm-k2",
                 "bf16": "chain"}


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 3, 5, 8, 16])
@pytest.mark.parametrize("alg", list(ALGEBRA_CASES))
def test_spmm_feature_counts_bit_equal(alg, F, cuda_device):
    """The SpMM kernel at F features (Fp = 4, 8 or 16 in the XT) bit for
    bit against its plain version on a stream of arbitrary idx words, each
    feature equal to the SpMV kernel on its column's build_xt, the empty
    block at the identity."""
    cfg = _algebra_cfg(alg, ALGEBRA_CASES[alg])
    (v, idx, part, cmap, start, end, _), rng, dev = fuzz_stream(
        cfg, cuda_device)
    if alg == "bf16":
        v = v.to(torch.bfloat16)
    X = dev(rng.standard_normal((2 * cfg.vb_cols - 3, F)), np.float32)
    xt = build_xt_multi(X, cfg, 2)
    assert xt.shape[-1] == -(-F // 4) * 4
    args = (v, idx, part, cmap, start, end, xt, cfg)
    before = _kernels.spmm_launches
    acc = wavepack_spmm(*args, F=F)
    torch.cuda.synchronize()
    assert _kernels.spmm_launches == before + 1
    assert acc.shape == (F, 3 * cfg.sublanes, 128)
    _exact(acc, spmm_tiles_plain(*args, F=F))
    for f in range(F):
        _exact(acc[f], wavepack_spmv(v, idx, part, cmap, start, end,
                                     build_xt(X[:, f], cfg, 2), cfg))
    ident = {"min_plus": float("inf"), "max_times": float("-inf")}
    assert (acc.reshape(F, 3, cfg.sublanes, 128)[:, 1]
            == ident.get(alg, 0.0)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chain", "bm-k2-steal-tc-idx16"])
def test_pipeline_short_and_ragged_runs(case, cuda_device):
    """Runs of 0, 1 and 2 tiles (shorter than the ring's depth), of 4, and
    of 7, 3 and 5 (not multiples of it), through the SpMV, SpMM (F = 5)
    and masked kernels, bit for bit against their plain versions; the
    masked selection skips tiles inside runs and whole runs."""
    from hisparse_tpu_torch.ops.spmv import block_runs
    runs = (0, 1, 2, 7, 3, 4, 0, 5)
    cfg = _algebra_cfg("plus_times", case)
    (v, idx, part, cmap, start, end, block), rng, dev = fuzz_stream(
        cfg, cuda_device, runs=runs)
    xt = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128)),
             np.float32)
    args = (v, idx, part, cmap, start, end, xt, cfg)
    _exact(wavepack_spmv(*args), spmv_tiles_plain(*args))
    X = dev(rng.standard_normal((2 * cfg.vb_cols, 5)), np.float32)
    sargs = (v, idx, part, cmap, start, end, build_xt_multi(X, cfg, 2), cfg)
    _exact(wavepack_spmm(*sargs, F=5), spmm_tiles_plain(*sargs, F=5))
    # gaps inside runs; block 2 (tiles 1-2) and block 5 (13-16) unselected
    sel = np.array([0, 3, 5, 6, 9, 11, 12, 17, 19, 21], np.int32)
    s_, e_ = block_runs(block.cpu().numpy()[sel], len(runs))
    margs = (v, idx, dev(sel), part, cmap, dev(s_), dev(e_), xt, cfg)
    acc = wavepack_spmv_masked(*margs)
    _exact(acc, spmv_masked_tiles_plain(*margs))
    assert (acc.reshape(len(runs), cfg.sublanes, 128)[[0, 2, 5, 6]]
            == 0).all()


@pytest.mark.cuda
def test_kernel_info_keeps_occupancy(cuda_device):
    """Every SpMV and masked instantiation, in both CTA shapes (narrow for
    a pack of one row block, wide for a pack of many), keeps the SM's
    2,048 threads resident without spilling, and no SpMM instantiation
    spills; each runs a ring of at least 3 stages."""
    kinds = [("plus_times", "fp32"), ("max_times", "fp32"),
             ("min_plus", "fp32"), ("plus_times", "bf16"),
             ("plus_times", "fixed")]
    flags = [(False, False, False), (False, False, True),
             (False, True, False), (False, True, True),
             (True, True, False), (True, True, True)]
    n = 0
    for (sr, dtype), (idx16, steal, bm) in itertools.product(kinds, flags):
        if (steal and (sr == "min_plus" or dtype != "fp32")):
            continue
        for which, Fp, n_blocks in (
                ("wavepack_spmv", 1, 1), ("wavepack_spmv", 1, 64),
                ("wavepack_spmv_masked", 1, 1),
                ("wavepack_spmv_masked", 1, 64), ("wavepack_spmm", 4, 1),
                ("wavepack_spmm", 8, 1), ("wavepack_spmm", 16, 1)):
            if dtype == "fixed" and which != "wavepack_spmv":
                continue
            info = _kernels.kernel_info(which, semiring=sr, dtype=dtype,
                                        idx16=idx16, steal=steal,
                                        block_major=bm, Fp=Fp,
                                        n_blocks=n_blocks)
            assert info["local_bytes"] == 0, (which, sr, dtype, info)
            assert info["stages"] >= 3
            if Fp == 1:
                assert info["ctas_per_sm"] * info["threads"] == 2048, (
                    which, sr, dtype, info)
                assert info["threads"] == (512 if n_blocks == 1 else 1024)
            n += 1
    assert n == 116


@pytest.mark.cuda
def test_misaligned_operands_raise(cuda_device):
    """A stream or XT that does not start on a 16-byte boundary (the
    kernels copy it in 16-byte chunks) raises before any launch."""
    m, wp, x = family_case(FP32_FAMILIES[0])
    op = SpmvOperator(wp, device=cuda_device)
    args = list(op.stream_args(torch.from_numpy(x).to(cuda_device)))
    buf = torch.empty(op.vals.numel() + 1, device=cuda_device)
    args[0] = buf[1:].view(op.vals.shape).copy_(op.vals)
    before = _kernels.launches
    with pytest.raises(ValueError, match="16-byte"):
        wavepack_spmv(*args, op.cfg)
    assert _kernels.launches == before
    X = torch.zeros(wp.num_cols, 4, device=cuda_device)
    xt = build_xt_multi(X, op.cfg, wp.n_parts)
    xbuf = torch.empty(xt.numel() + 1, device=cuda_device)
    xt = xbuf[1:].view(xt.shape)
    with pytest.raises(ValueError, match="16-byte"):
        wavepack_spmm(op.vals, op.idxT, op.tile_part, op.class_map,
                      op.run_start, op.run_end, xt, op.cfg)
