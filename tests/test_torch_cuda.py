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
bit for bit against its plain version and against the full SpMV.
"""
import numpy as np
import pytest
import torch

from hisparse_tpu_torch import SpmvOperator
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.golden import spmv_f64
from hisparse_tpu_torch.ops.spmv import (
    SPMM_MAX_F, build_xt, build_xt_multi,
    gradstream_tiles_plain, spmm_tiles_plain, spmv_masked_tiles_plain,
    spmv_tiles_plain, wavepack_gradstream, wavepack_spmm, wavepack_spmv,
    wavepack_spmv_masked)
from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES, MULTIBLOCK_FAMILY,
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


@pytest.mark.cuda
@pytest.mark.parametrize("fam", FP32_FAMILIES + (MULTIBLOCK_FAMILY,),
                         ids=lambda f: f[0])
def test_kernel_matches_plain_on_cuda(fam, cuda_device):
    """Kernel vs plain version on the same CUDA operands; the launch
    counter rises by one per kernel call and the operator's y matches the
    golden."""
    m, wp, x = family_case(fam)
    op = SpmvOperator(wp, device=cuda_device)
    x_dev = torch.from_numpy(x).to(cuda_device)
    args = op.stream_args(x_dev if op.col_order is None
                          else x_dev[op.col_order])
    before = _kernels.launches
    acc = wavepack_spmv(*args, op.cfg)
    torch.cuda.synchronize()
    assert _kernels.launches == before + 1
    plain = spmv_tiles_plain(*args, op.cfg)
    assert _err(op.renamed_y(acc), op.renamed_y(plain)) <= 1e-6
    y = op(x_dev)
    assert y.device.type == "cuda" and y.shape == (m.num_rows,)
    assert _err(y, torch.from_numpy(spmv_f64(m, x))) <= 1e-4


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
}


def fuzz_stream(cfg, dev):
    """6 tiles of arbitrary idx words (b-fields out of range included)
    over 3 row blocks, the middle block empty, tiles spread over 2 column
    partitions: (vals, idxT, tile_part, cmap, run_start, run_end,
    tile_block) on dev, and a numpy generator for more operands."""
    rng = np.random.default_rng(11)
    T, S, n_parts = 6, cfg.sublanes, 2
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

    stream = (dev_(v), dev_(idx), dev_(rng.integers(0, n_parts, T), np.int32),
              dev_(cmap, np.int32) if cfg.block_major else None,
              dev_([0, 2, 2], np.int32), dev_([2, 2, 6], np.int32),
              dev_([0, 0, 2, 2, 2, 2], np.int32))
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

    xtm = dev(rng.standard_normal((2, 5, cfg.total_blocks, 128, 128)),
              np.float32)
    args = (v, idx, part, cmap, start, end, xtm)
    accm = wavepack_spmm(*args, cfg)
    torch.testing.assert_close(accm, spmm_tiles_plain(*args, cfg), rtol=0,
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
        acc = wavepack_spmm(*sargs)
        torch.cuda.synchronize()
        assert _kernels.spmm_launches == before + 1
        assert _err(acc, spmm_tiles_plain(*sargs)) <= 1e-6
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
    xtm = dev(rng.standard_normal((2, 5, cfg.total_blocks, 128, 128)),
              np.float32)
    args = (v, idx, part, cmap, start, end, xtm)
    _exact(wavepack_spmm(*args, cfg), spmm_tiles_plain(*args, cfg))
    # tiles 1, 3 and 5: block 0 keeps one, block 2 two
    margs = (v, idx, dev([1, 3, 5], np.int32), part, cmap,
             dev([0, 1, 1], np.int32), dev([1, 1, 3], np.int32), xt, cfg)
    _exact(wavepack_spmv_masked(*margs), spmv_masked_tiles_plain(*margs))
