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
words every kernel is held bit for bit.
"""
import numpy as np
import pytest
import torch

from hisparse_tpu_torch import SpmvOperator
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.golden import spmv_f64
from hisparse_tpu_torch.ops.spmv import (
    SPMM_MAX_F, build_xt, build_xt_multi, gradstream_tiles_plain,
    spmm_tiles_plain, spmv_tiles_plain, wavepack_gradstream, wavepack_spmm,
    wavepack_spmv)
from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES, MULTIBLOCK_FAMILY,
                                           family_case)


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
