"""The port's CUDA kernel against its plain PyTorch version, on a GPU.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false.  The file imports no JAX (the
GPU machine need not have it); run it there with the repository's
conftest, which imports JAX, left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, as max|dy| / max(max|y|, 1): kernel against plain version
1e-6 (both sum each slot's terms in stream order, multiply and add rounded
separately, so only an FMA-free difference could show); natural-order y
against the f64 golden 1e-4 (the suite's gate).
"""
import numpy as np
import pytest
import torch

from hisparse_tpu_torch import SpmvOperator
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.golden import spmv_f64
from hisparse_tpu_torch.ops.spmv import spmv_tiles_plain, wavepack_spmv
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUZZ_CASES))
def test_kernel_matches_plain_on_arbitrary_words(case, cuda_device):
    """Kernel vs plain version, bit for bit, on a stream of arbitrary idx
    words (b-fields out of range included): 6 tiles over 3 row blocks, the
    middle block empty, tiles spread over 2 column partitions."""
    from hisparse_tpu_torch import SpmvConfig
    cfg = SpmvConfig(sublanes=256, stripes=128, **FUZZ_CASES[case])
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
    xt = rng.standard_normal((n_parts, cfg.total_blocks, 128, 128))

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            cuda_device)

    args = (dev(v), dev(idx), dev(rng.integers(0, n_parts, T), np.int32),
            dev(cmap, np.int32) if cfg.block_major else None,
            dev([0, 2, 2], np.int32), dev([2, 2, 6], np.int32),
            dev(xt, np.float32))
    acc = wavepack_spmv(*args, cfg)
    plain = spmv_tiles_plain(*args, cfg)
    torch.testing.assert_close(acc, plain, rtol=0, atol=0)
    assert (acc.reshape(3, S, 128)[1] == 0).all()
