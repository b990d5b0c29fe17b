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
accumulation is not IEEE-ordered) within 1e-4.  The renamed -> natural
fold adds each row's partials in one fixed order, so natural-order y is
held bit for bit: against the plain fold, against ``Wavepack.unpack_y``
and between two runs, in both its layouts ((F, renamed), and (renamed,
F) with ``dim=0``, what ``matmul`` folds) and on the hand-made edge plan
of ``utils/bench.fold_edge_plan`` (NaN payloads held for min and max).  The mesh cases put four shards on one card
(``hisparse_tpu_torch.parallel``) and hold them against the single-device
results (min_plus, SSSP, BFS bit for bit; the GCN within 1e-5), the f64
golden (1e-4) and the same module on a CPU mesh (1e-6; gradient streams,
dL/dvals and Q8.24 words bit for bit).  ``HybridSpmv`` launches the SpMV
kernel twice a forward, each launch within 1e-6 of its plain version, its
natural y bit for bit the CPU operator's; ``measured_peak_gbps`` lies
between 0.3 and 1.05 of the data sheet's rate, and a ``device_profile``
trace holds the SpMV kernel's launch.
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
    counted once; SpMM at F in {1, 5, 16}, and through the wide
    instantiation at F in WIDE_FS bit for bit, each feature equal to the
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
    for F in (1, 5, 16) + WIDE_FS:
        X = torch.from_numpy(rng.standard_normal(
            (wp.num_cols, F)).astype(np.float32)).to(cuda_device)
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(X, cfg, wp.n_parts), cfg)
        before = _kernels.spmm_launches
        wide = _kernels.spmm_wide_launches
        acc = wavepack_spmm(*sargs, F=F)
        torch.cuda.synchronize()
        assert _kernels.spmm_launches == before + 1
        assert _kernels.spmm_wide_launches == wide + (F > 16)
        assert acc.shape == (F, wp.n_blocks * S, 128)
        if F in WIDE_FS:
            _exact(acc, spmm_tiles_plain(*sargs, F=F))
        else:
            assert _err(acc, spmm_tiles_plain(*sargs, F=F)) <= 1e-6
        y_ren = op.matmul(X, renamed=True)
        assert _err(y_ren[F - 1], op(X[:, F - 1], renamed=True)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("fam", FP32_FAMILIES + (MULTIBLOCK_FAMILY,),
                         ids=lambda f: f[0])
def test_matmul_wide_equals_narrow_chunks_on_cuda(fam, cuda_device):
    """matmul at F = 100 (launches of 64 and 36 features, the wide
    instantiation) bit for bit the same features taken 16 at a time
    (kF = 16), in natural and renamed order; the wide launches counted."""
    m, wp, x = family_case(fam)
    op = SpmvOperator(wp, device=cuda_device)
    X = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (wp.num_cols, 100)).astype(np.float32)).to(cuda_device)
    before = _kernels.spmm_launches
    wide = _kernels.spmm_wide_launches
    Y = op.matmul(X)
    torch.cuda.synchronize()
    assert _kernels.spmm_launches - before == -(-100 // SPMM_MAX_F)
    assert _kernels.spmm_wide_launches - wide == -(-100 // SPMM_MAX_F)
    wide = _kernels.spmm_wide_launches
    for renamed, dim, got in ((False, 1, Y),
                              (True, 0, op.matmul(X, renamed=True))):
        want = torch.cat([op.matmul(X[:, f0:f0 + 16], renamed=renamed)
                          for f0 in range(0, 100, 16)], dim=dim)
        _exact(got, want)
    assert _kernels.spmm_wide_launches - wide == -(-100 // SPMM_MAX_F)


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


# the feature counts at which the wide SpMM instantiation is held bit for
# bit against its plain version
WIDE_FS = (20, 36, 48, 64)


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
    active columns, and masked == full in natural order; the masked
    counter rises by one per launch."""
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
    # natural order: the fold adds a split row's partials in one order
    _exact(op.masked(x_dev, act), op(x_dev))


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
@pytest.mark.parametrize("k", [1, 5, 16, 64, 72, 128])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bcsr_kernel_matches_plain_on_cuda(dtype, k, cuda_device):
    """The BCSR kernel against its plain version on a block-structured
    matrix with empty block rows, each launch counted once, at kp = 8
    (k = 1 and 5), 16, 64, 72 (a ragged last column chunk) and 128; the
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
@pytest.mark.parametrize("F", [1, 3, 5, 8, 16, 20, 36, 48, 64])
@pytest.mark.parametrize("alg", list(ALGEBRA_CASES))
def test_spmm_feature_counts_bit_equal(alg, F, cuda_device):
    """The SpMM kernel at F features (Fp = 4, 8 or 16 in the XT, or up to
    64 through the wide instantiation) bit for bit against its plain
    version on a stream of arbitrary idx words, each
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
    of 7, 3 and 5 (not multiples of it), through the SpMV, SpMM (F = 5,
    and F = 36 through the wide instantiation) and masked kernels, bit
    for bit against their plain versions; the masked selection skips
    tiles inside runs and whole runs."""
    from hisparse_tpu_torch.ops.spmv import block_runs
    runs = (0, 1, 2, 7, 3, 4, 0, 5)
    cfg = _algebra_cfg("plus_times", case)
    (v, idx, part, cmap, start, end, block), rng, dev = fuzz_stream(
        cfg, cuda_device, runs=runs)
    xt = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128)),
             np.float32)
    args = (v, idx, part, cmap, start, end, xt, cfg)
    _exact(wavepack_spmv(*args), spmv_tiles_plain(*args))
    for F in (5, 36):
        X = dev(rng.standard_normal((2 * cfg.vb_cols, F)), np.float32)
        sargs = (v, idx, part, cmap, start, end, build_xt_multi(X, cfg, 2),
                 cfg)
        _exact(wavepack_spmm(*sargs, F=F), spmm_tiles_plain(*sargs, F=F))
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
    spills; each runs a ring of at least 3 stages, the wide SpMM's at
    least 512 threads an SM."""
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
                ("wavepack_spmm", 8, 1), ("wavepack_spmm", 16, 1),
                ("wavepack_spmm", SPMM_MAX_F, 1)):
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
            if Fp > 16:
                assert info["ctas_per_sm"] * info["threads"] >= 512, (
                    which, sr, dtype, info)
            n += 1
    assert n == 132


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


# the fold's cases: a power-law matrix whose hub rows split into up to 113
# partials (more than FOLD_THREAD_MAX: warp-folded rows), in each algebra
FOLD_ALGEBRAS = ("plus_times", "min_plus", "max_times", "fixed")


def _fold_op(alg, dev):
    from hisparse_tpu_torch import SpmvConfig, pack, powerlaw_csr
    from hisparse_tpu_torch.ops.golden import float_to_fixed
    import dataclasses
    kw = dict(sublanes=128, bank_blocks=1, stripes=128, two_choice=False)
    kw.update(dtype="fixed" if alg == "fixed" else "fp32",
              semiring="plus_times" if alg == "fixed" else alg)
    m = powerlaw_csr(700, 900, 8, alpha=1.1, seed=9)
    if alg == "fixed":
        m = dataclasses.replace(m, data=float_to_fixed(np.abs(m.data) / 8))
    wp = pack(m, SpmvConfig(**kw), split_max=8)
    op = SpmvOperator(wp, device=dev)
    assert op.fold_long.numel() > 0
    return m, wp, op


def _words(t):
    """A float32 or int32 tensor's words as numpy uint32, NaNs as one."""
    a = t.detach().cpu()
    if a.dtype == torch.float32:
        a = torch.where(torch.isnan(a), torch.full_like(a, float("nan")), a)
    return a.contiguous().view(torch.int32).numpy().view(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", FOLD_ALGEBRAS)
def test_row_fold_matches_plain_on_cuda(alg, cuda_device):
    """The fold kernel bit for bit against its plain version and
    ``Wavepack.unpack_y``, on (renamed,) and (F, renamed) inputs with
    +inf, -inf, signed zeros, NaNs and saturating Q8.24 words; twice, the
    same bits; each launch counted once."""
    from hisparse_tpu_torch.ops.spmv import row_fold, row_fold_plain
    m, wp, op = _fold_op(alg, cuda_device)
    rng = np.random.default_rng(3)
    n = wp.perm.size
    if alg == "fixed":
        Y = rng.integers(0, 1 << 32, (3, n), dtype=np.uint64).astype(
            np.uint32)
        Yt = torch.from_numpy(Y.view(np.int32)).to(cuda_device)
    else:
        Y = rng.standard_normal((3, n)).astype(np.float32)
        pick = rng.random((3, n))
        Y[pick < 0.1] = np.inf if alg == "min_plus" else -np.inf
        Y[(pick >= 0.1) & (pick < 0.2)] = -0.0
        Y[(pick >= 0.2) & (pick < 0.3)] = 0.0
        Y[:, n // 2] = np.nan
        Yt = torch.from_numpy(Y).to(cuda_device)
    plan = (op.fold_idx, op.fold_ptr, op.fold_long)
    for y in (Yt[0], Yt):
        before = _kernels.fold_launches
        out = row_fold(y.contiguous(), *plan, alg)
        again = row_fold(y.contiguous(), *plan, alg)
        torch.cuda.synchronize()
        assert _kernels.fold_launches == before + 2
        plain = row_fold_plain(y, op.fold_idx, op.fold_ptr, alg)
        np.testing.assert_array_equal(_words(out), _words(plain))
        np.testing.assert_array_equal(_words(out), _words(again))
    for f in range(3):
        np.testing.assert_array_equal(_words(out[f]),
                                      _words(torch.from_numpy(
                                          wp.unpack_y(Y[f]).view(
                                              np.int32 if alg == "fixed"
                                              else np.float32))))


@pytest.mark.cuda
@pytest.mark.parametrize("alg", FOLD_ALGEBRAS)
def test_natural_order_is_fixed_on_cuda(alg, cuda_device):
    """Natural-order y of ``forward`` (and for the float algebras of
    ``masked`` and ``matmul``) is bit-equal between two runs and to
    ``Wavepack.unpack_y`` of the same call's renamed y, on a hub-split
    pack; the fold kernel runs on each natural-order call."""
    from hisparse_tpu_torch.ops.golden import float_to_fixed
    m, wp, op = _fold_op(alg, cuda_device)
    rng = np.random.default_rng(4)
    x = rng.random(wp.num_cols).astype(np.float32)
    if alg == "fixed":
        x = float_to_fixed(x)
        y1, y2 = op(x), op(x)
        ren = op(x, renamed=True).view(torch.int32).cpu().numpy().view(
            np.uint32)
        assert y1.dtype == torch.uint32 and y1.device.type == "cpu"
        np.testing.assert_array_equal(y1.numpy(), y2.numpy())
        np.testing.assert_array_equal(y1.numpy(), wp.unpack_y(ren))
        return
    x_dev = torch.from_numpy(x).to(cuda_device)
    active = np.flatnonzero(rng.random(wp.num_cols) < 0.3)
    xs = x_dev.clone() if alg != "min_plus" else torch.full_like(
        x_dev, float("inf"))
    if alg != "min_plus":
        xs.zero_()
    xs[torch.from_numpy(active).to(cuda_device)] = x_dev[
        torch.from_numpy(active).to(cuda_device)]
    X = torch.from_numpy(rng.random((wp.num_cols, 5)).astype(
        np.float32)).to(cuda_device)
    before = _kernels.fold_launches
    for call in (lambda r: op(x_dev, renamed=r),
                 lambda r: op.masked(xs, active, renamed=r)):
        a, b = call(False), call(False)
        _exact(a, b)
        ref = wp.unpack_y(call(True).cpu().numpy())
        np.testing.assert_array_equal(_words(a), _words(torch.from_numpy(
            ref)))
    Y1, Y2 = op.matmul(X), op.matmul(X)
    assert Y1.shape == (wp.num_rows, 5) and Y1.is_contiguous()
    _exact(Y1, Y2)
    Y_ren = op.matmul(X, renamed=True).cpu().numpy()
    for f in range(5):
        np.testing.assert_array_equal(
            _words(Y1[:, f]), _words(torch.from_numpy(wp.unpack_y(Y_ren[f]))))
    assert _kernels.fold_launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("F", (1, 3, 4, 16, 20, 33))
@pytest.mark.parametrize("alg", FOLD_ALGEBRAS)
def test_row_fold_edge_plan_on_cuda(alg, F, cuda_device):
    """The fold kernel on the hand-made edge plan
    (``utils/bench.fold_edge_plan``: hub rows of signed-zero ties,
    infinities and two NaN payloads over several ring stages, a saturating
    Q8.24 hub row, rows of 32 and 33 partials) bit for bit against its
    plain version in both layouts: (renamed, F) with ``dim=0`` (16-byte
    loads where F % 4 == 0, and scalar ones from an address 4 bytes off
    16), and (F, renamed).  min_plus and max_times select a partial, so
    their NaN payloads are held too; a sum's NaN payload is the
    hardware's."""
    from hisparse_tpu_torch.ops.spmv import fold_plan, row_fold, row_fold_plain
    from hisparse_tpu_torch.utils.bench import fold_edge_plan, fold_edge_values
    perm, n = fold_edge_plan()
    plan = [torch.from_numpy(a).to(cuda_device)
            for a in fold_plan(perm, n)]
    Y = fold_edge_values(alg, perm, F)
    y = torch.from_numpy(Y.view(np.int32) if alg == "fixed" else Y).to(
        cuda_device)

    def words(t):
        if alg == "plus_times":
            return _words(t)
        return t.detach().cpu().contiguous().view(torch.int32).numpy()

    plain = row_fold_plain(y, *plan[:2], alg, dim=0)
    off = torch.empty(y.numel() + 1, dtype=y.dtype, device=cuda_device)
    y_off = off[1:].view(y.shape)
    y_off.copy_(y)
    before = _kernels.fold_launches
    for inp in (y, y_off):
        out = row_fold(inp, *plan, alg, dim=0)
        assert out.shape == (n, F) and out.is_contiguous()
        np.testing.assert_array_equal(words(out), words(plain))
    out = row_fold(y.T.contiguous(), *plan, alg)
    torch.cuda.synchronize()
    assert out.shape == (F, n)
    np.testing.assert_array_equal(words(out), words(plain.T))
    assert _kernels.fold_launches == before + 3


@pytest.mark.cuda
def test_fadd_latency_is_a_few_clocks(cuda_device):
    """The dependent-add timer behind the fold's chain floor reads a few
    SM clocks an add."""
    assert 1.0 <= _kernels.fadd_latency_cycles() <= 32.0


@pytest.mark.cuda
def test_row_fold_rejects_bad_operands(cuda_device):
    """The fold wrapper checks dtype, shape and device before it
    launches."""
    from hisparse_tpu_torch.ops.spmv import row_fold
    _, wp, op = _fold_op("plus_times", cuda_device)
    y = torch.zeros(wp.perm.size, device=cuda_device)
    plan = (op.fold_idx, op.fold_ptr, op.fold_long)
    before = _kernels.fold_launches
    for bad in (y.double(), y.to(torch.int32), y[None, None]):
        with pytest.raises(ValueError):
            row_fold(bad, *plan, "plus_times")
    with pytest.raises(ValueError):
        row_fold(y, op.fold_idx.long(), *plan[1:], "plus_times")
    assert _kernels.fold_launches == before


# packs of one bank block (CT == 1), as both transformer-70 training packs
ONE_BLOCK_CASES = {
    "b1-chain": dict(bank_blocks=1, two_choice=False),
    "b1-steal": dict(bank_blocks=1, two_choice=False, steal_mantissa=True),
    "b1-steal-idx16": dict(bank_blocks=1, two_choice=False,
                           steal_mantissa=True, idx16=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUZZ_CASES) + list(ONE_BLOCK_CASES))
@pytest.mark.parametrize("S", [128, 512])
def test_gradstream_pack_kinds_bit_equal(case, S, cuda_device):
    """The gradient-stream kernel bit for bit against its plain version on
    every kind of pack route.cuh dispatches (idx16 or int32, steal or
    not, block-major or select-chain) and on packs of one bank block, at
    S = 128 and at S = 512 (the transformer-70 packs' sublanes), over
    three row blocks (one empty) and over 7 tiles, their tiles in two
    column partitions; a zero mask zeroes its slots."""
    from hisparse_tpu_torch import SpmvConfig
    kw = FUZZ_CASES[case] if case in FUZZ_CASES else ONE_BLOCK_CASES[case]
    cfg = SpmvConfig(sublanes=S, stripes=128, **kw)
    for runs in ((2, 0, 4), (7,)):
        (v, idx, part, cmap, start, end, block), rng, dev = fuzz_stream(
            cfg, cuda_device, runs=runs)
        xt = dev(rng.standard_normal((2, cfg.total_blocks, 128, 128)),
                 np.float32)
        mask = dev(rng.random(v.shape) < 0.7, np.float32)
        g_acc = dev(rng.standard_normal((len(runs) * S, 128)), np.float32)
        args = (v, idx, mask, part, block, cmap, g_acc, xt, cfg)
        out = wavepack_gradstream(*args)
        _exact(out, gradstream_tiles_plain(*args))
        assert (out[mask == 0] == 0).all()


@pytest.mark.cuda
def test_gradstream_on_the_training_packs(cuda_device):
    """The gradient stream bit for bit on both transformer-70-shaped packs
    (a narrow uniform matrix, steal + idx16, S = 512, stripes 4 for A and
    512 for A^T, as chip_smoke.py's training phase), through
    ``grad_stream_operands``, the operands the backward builds."""
    from hisparse_tpu_torch import (SpmvConfig, StreamDiffSpmv,
                                    uniform_sparse_csr)
    from hisparse_tpu_torch.ops.train_stream import grad_stream_operands
    cfg = dict(sublanes=512, bank_blocks=1, stripes=4, steal_mantissa=True,
               idx16=True, two_choice=False)
    m = uniform_sparse_csr(256, 6000, 1500, seed=70)
    sd = StreamDiffSpmv(m, SpmvConfig(**cfg),
                        SpmvConfig(**dict(cfg, stripes=512)),
                        device=cuda_device, split_max=None)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(sd.num_cols).astype(
        np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal(sd.num_rows).astype(
        np.float32)).to(cuda_device)
    for ops in ((sd.d.op, sd.vA.detach(), sd.maskA, g, x),
                (sd.d.opT, sd.vT.detach(), sd.maskT, x, g)):
        gargs = grad_stream_operands(*ops)
        _exact(wavepack_gradstream(*gargs), gradstream_tiles_plain(*gargs))


# -- the mesh: four shards on one card --------------------------------------


def _mesh(dev, shape=(4,), names=("rows",)):
    from hisparse_tpu_torch.parallel import Mesh
    return Mesh(np.array([dev] * 4).reshape(shape), names)


@pytest.mark.cuda
def test_mesh_spmv_four_shards_on_cuda(cuda_device):
    """``ShardedSpmv`` on four shards of ``cuda:0``: one SpMV launch and
    one fold a shard, natural y bit-equal run to run and within 1e-4 of
    the f64 golden; the 2 x 2 ``ShardedSpmv2D`` within 1e-6 of it; in
    min_plus both bit-equal to the single-device operator's y."""
    from hisparse_tpu_torch import SpmvConfig, pack, powerlaw_csr
    from hisparse_tpu_torch.parallel import ShardedSpmv, ShardedSpmv2D
    m = powerlaw_csr(3000, 2800, 9, alpha=1.2, seed=2)
    x = np.random.default_rng(1).random(m.num_cols).astype(np.float32)
    cfg = SpmvConfig(sublanes=128, bank_blocks=1, stripes=128)
    op = ShardedSpmv(m, _mesh(cuda_device), cfg, split_max=32)
    b_spmv, b_fold = _kernels.launches, _kernels.fold_launches
    y1 = op.unpack_y(op(x))
    assert (_kernels.launches - b_spmv, _kernels.fold_launches - b_fold) \
        == (4, 4)
    assert y1.device.type == "cuda" and y1.shape == (m.num_rows,)
    _exact(y1, op.unpack_y(op(x)))
    assert _err(y1, torch.from_numpy(spmv_f64(m, x))) <= 1e-4
    op2 = ShardedSpmv2D(m, _mesh(cuda_device, (2, 2), ("rows", "cols")),
                        cfg, split_max=32)
    assert _err(op2.unpack_y(op2(x)), y1) <= 1e-6
    tropical = SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                          semiring="min_plus", two_choice=False)
    y_one = SpmvOperator(pack(m, tropical, split_max=32), cuda_device)(
        torch.from_numpy(x).to(cuda_device))
    for o in (ShardedSpmv(m, _mesh(cuda_device), tropical, split_max=32),
              ShardedSpmv2D(m, _mesh(cuda_device, (2, 2),
                                     ("rows", "cols")), tropical,
                            split_max=32)):
        _exact(o.unpack_y(o(x)), y_one)


@pytest.mark.cuda
def test_mesh_fixed_point_on_cuda(cuda_device):
    """A Q8.24 ``ShardedSpmv`` on four shards of ``cuda:0`` folds each
    shard's words on the card (one fold launch a shard, the saturating
    sum) and returns natural y as uint32 words, bit-equal to
    ``spmv_fixed_vec`` and to the same module on a CPU mesh."""
    from hisparse_tpu_torch import SpmvConfig, uniform_sparse_csr
    from hisparse_tpu_torch.ops.golden import float_to_fixed
    from hisparse_tpu_torch.parallel import ShardedSpmv
    m = uniform_sparse_csr(3000, 2500, 8, seed=21)
    m.data = float_to_fixed(m.data / m.num_cols)
    x = float_to_fixed(np.random.default_rng(5).random(m.num_cols))
    cfg = SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                     dtype="fixed", two_choice=False)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        op = ShardedSpmv(m, _mesh(dev), cfg, split_max=16)
        b_fold = _kernels.fold_launches
        y = op.unpack_y(op(x))
        if dev.type == "cuda":
            assert _kernels.fold_launches - b_fold == 4
        assert y.dtype == torch.uint32 and y.device.type == "cpu"
        out.append(y.numpy())
    np.testing.assert_array_equal(out[0], spmv_fixed_vec(m, x, m.data))
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.cuda
def test_mesh_diff_spmv_on_cuda(cuda_device):
    """``ShardedDiffSpmv`` on four shards of ``cuda:0``, its values
    scattered into the shards' streams each call: y and dL/dx within 1e-6
    of the same module on a CPU mesh and 1e-4 of float64, dL/dvals
    bit-equal to it and to g[rows] * x[cols]; four SpMV launches forward
    and four backward."""
    from hisparse_tpu_torch import SpmvConfig, powerlaw_csr
    from hisparse_tpu_torch.parallel import ShardedDiffSpmv
    m = powerlaw_csr(2500, 2200, 8, alpha=1.2, seed=12)
    cfg = SpmvConfig(sublanes=128, bank_blocks=2, stripes=128,
                     block_major=True, classes_per_group=2,
                     two_choice=False)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(2200).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(2500).astype(np.float32))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        sd = ShardedDiffSpmv(m, _mesh(dev), cfg)
        xg = x.to(dev, copy=True).requires_grad_(True)
        before = _kernels.launches
        y = sd(xg)
        y.backward(g.to(dev))
        if dev.type == "cuda":
            assert _kernels.launches - before == 8
        out.append((y.detach(), xg.grad,
                    torch.from_numpy(sd.unstack_values(
                        [v.grad for v in sd.vals]))))
    (y, gx, gv), (y_p, gx_p, gv_p) = out
    assert _err(y, y_p) <= 1e-6 and _err(gx, gx_p) <= 1e-6
    a = sd.m.to_scipy().astype(np.float64)
    assert _err(y, torch.from_numpy(a @ x.double().numpy())) <= 1e-4
    assert _err(gx, torch.from_numpy(a.T @ g.double().numpy())) <= 1e-4
    _exact(gv, gv_p)
    rows = np.repeat(np.arange(sd.m.num_rows), np.diff(sd.m.indptr))
    _exact(gv, torch.from_numpy(g.numpy()[rows] * x.numpy()[sd.m.indices]))


@pytest.mark.cuda
def test_mesh_stream_training_on_cuda(cuda_device):
    """One ``ShardedStreamDiffSpmv`` step on four shards of ``cuda:0``
    against the same module on a CPU mesh (the plain versions): y and
    dL/dx within 1e-6, every shard's gradient streams bit-equal, eight
    gradient-stream launches; after ``sgd_step`` the layouts agree."""
    from hisparse_tpu_torch import SpmvConfig, uniform_sparse_csr
    from hisparse_tpu_torch.parallel import ShardedStreamDiffSpmv
    cfg = dict(sublanes=512, bank_blocks=1, stripes=4, steal_mantissa=True,
               idx16=True, two_choice=False)
    m = uniform_sparse_csr(256, 6000, 1500, seed=70)
    cfgs = (SpmvConfig(**cfg), SpmvConfig(**dict(cfg, stripes=512)))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(6000).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        sd = ShardedStreamDiffSpmv(m, _mesh(dev), *cfgs, split_max=None)
        xg = x.to(dev).requires_grad_(True)
        before = _kernels.gradstream_launches
        y = sd(xg)
        y.backward(g.to(dev))
        if dev.type == "cuda":
            assert _kernels.gradstream_launches == before + 8
        out.append((y.detach(), xg.grad, [p.grad for p in sd.vA],
                    [p.grad for p in sd.vT]))
        sd.sgd_step(1e-4)
        np.testing.assert_array_equal(sd.values(), sd.values_T())
    (y, gx, gA, gT), (y_p, gx_p, gA_p, gT_p) = out
    assert _err(y, y_p) <= 1e-6 and _err(gx, gx_p) <= 1e-6
    for a, b in zip(gA + gT, gA_p + gT_p):
        _exact(a, b.to(cuda_device))


@pytest.mark.cuda
def test_mesh_gcn_and_apps_on_cuda(cuda_device):
    """``ShardedGCN`` logits within 1e-5 of the single-device ``GCN`` on
    the same parameters, through the SpMM kernel; ``ShardedPageRank``
    within 1e-5 of the golden; ``ShardedSSSP`` distances and
    ``ShardedBFS`` levels equal to the single-device apps'."""
    from hisparse_tpu_torch import (BFS, GCN, SSSP, SpmvConfig,
                                    pagerank_reference, powerlaw_csr,
                                    uniform_sparse_csr)
    from hisparse_tpu_torch.parallel import (ShardedBFS, ShardedGCN,
                                             ShardedPageRank, ShardedSSSP)
    mesh = _mesh(cuda_device)
    adj = powerlaw_csr(2000, 2000, 6.0, seed=3)
    cfg = SpmvConfig(sublanes=128, bank_blocks=1, stripes=128)
    one = GCN(adj, [16, 8, 4], cfg, device=cuda_device)
    gcn = ShardedGCN(adj, mesh, [16, 8, 4], cfg)
    gcn.load_params(one.params())
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2000, 16)).astype(np.float32)).to(cuda_device)
    before = _kernels.spmm_launches
    logits = gcn(X)
    assert _kernels.spmm_launches > before
    assert _err(logits.detach(), one(X).detach()) <= 1e-5
    r = ShardedPageRank(adj, mesh).run(iters=15)
    ref = pagerank_reference(adj, iters=15)
    assert float(np.abs(r.cpu().numpy() - ref).max()
                 / np.abs(ref).max()) <= 1e-5
    w = uniform_sparse_csr(3000, 3000, 5, seed=9)
    w.data[:] = np.abs(w.data) + 0.1
    _exact(ShardedSSSP(w, mesh).run(0), SSSP(w, device=cuda_device).run(0))
    assert torch.equal(ShardedBFS(w, mesh).run(0),
                       BFS(w, device=cuda_device).run(0))


@pytest.mark.cuda
@pytest.mark.parametrize("stop_frac", [0.25, 0.0])
def test_hybrid_launches_match_plain_on_cuda(stop_frac, cuda_device):
    """``HybridSpmv``: two SpMV launches a forward, each within 1e-6 of its
    plain version; y within 1e-4 of f64; natural y bit-equal run to run and
    to the CPU operator on the same packs.  ``stop_frac=0`` leaves the tail
    one tile of padding, which the kernel runs too."""
    from hisparse_tpu_torch import SpmvConfig, powerlaw_csr
    from hisparse_tpu_torch.formats.wavepack import pack_hybrid
    from hisparse_tpu_torch.ops.spmv import HybridSpmv
    m = powerlaw_csr(4000, 60000, 16, alpha=1.2, seed=5)
    cfg = SpmvConfig(sublanes=128, bank_blocks=4, stripes=128,
                     block_major=True, classes_per_group=2, two_choice=True)
    wb, wt = pack_hybrid(m, cfg, split_max=32, stop_frac=stop_frac,
                         col_order="degree")
    op = HybridSpmv(wb, wt, device=cuda_device)
    x = np.random.default_rng(5).random(m.num_cols).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    before = (_kernels.launches, _kernels.fold_launches)
    y = op(xd)
    torch.cuda.synchronize()
    assert (_kernels.launches, _kernels.fold_launches) == (
        before[0] + 2, before[1] + 1)
    for o in (op.bulk, op.tail):
        args = o.stream_args(xd[o.col_order])
        acc = wavepack_spmv(*args, o.cfg)
        assert _err(o.renamed_y(acc),
                    o.renamed_y(spmv_tiles_plain(*args, o.cfg))) <= 1e-6
    assert _err(y, torch.from_numpy(spmv_f64(m, x))) <= 1e-4
    _exact(y, op(xd))
    _exact(y.cpu(), HybridSpmv(wb, wt, device="cpu")(torch.from_numpy(x)))


@pytest.mark.cuda
def test_measured_peak_gbps_on_cuda(cuda_device):
    """The measured HBM read rate lies between 0.3 and 1.05 of the data
    sheet's."""
    from hisparse_tpu_torch.utils.bench import (device_hbm_gbps,
                                               measured_peak_gbps)
    hbm = device_hbm_gbps()
    assert 0.3 * hbm <= measured_peak_gbps() <= 1.05 * hbm


@pytest.mark.cuda
def test_device_profile_traces_the_kernel_on_cuda(cuda_device, tmp_path):
    """A ``device_profile`` trace of one forward holds the SpMV kernel's
    launch (``wavepack_kernel<...>``) among its CUDA kernel events."""
    import json
    from hisparse_tpu_torch.utils.tracing import device_profile
    _, wp, x = family_case(PLUS_TIMES_FAMILIES[0])
    op = SpmvOperator(wp, device=cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    op(xd)
    with device_profile(str(tmp_path), device="cuda") as prof:
        op(xd)
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "wavepack_kernel" in e["name"]
               for e in events)
