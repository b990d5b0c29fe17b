"""The port's BCSR path against the JAX package's on the CPU.

``pack_bcsr`` is compared with the JAX one field by field, and
``BcsrOperator(device="cpu")``, whose kernel wrapper runs the plain
PyTorch version (``torch.bmm`` of the blocks, ``index_add_`` by block row)
on CPU tensors, with the JAX ``BcsrOperator(interpret=True)`` on the same
matrix and the same numpy-seeded x.  Both cast x to the blocks' dtype
first and accumulate in fp32, and a product of two bf16 values is exact in
fp32, so only the order of the sums differs: the tolerance is 1e-6 of
max|Y| for fp32 and bf16 blocks alike.  The CUDA kernel is held against
the plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.bcsr import (BS, bcsr_plain, bcsr_spmm,
                                         pack_bcsr)

TOL = 1e-6

# the matrices of tests/test_dense.py's BCSR cases, a small block-structured
# one (the bcsr-spmm-16k generator at 4 x 4 block rows) and one without
# nonzeros
MATRICES = {
    "powerlaw": ("powerlaw_csr", (500, 700, 20), dict(seed=6)),
    "uniform": ("uniform_sparse_csr", (300, 400, 40), dict(seed=7)),
    "block": ("block_structured_csr", (512, 512),
              dict(block_rows=2, seed=3)),
    "empty": ("uniform_sparse_csr", (200, 300, 0), dict(seed=1)),
}


def _matrices(name):
    gen, args, kw = MATRICES[name]
    return getattr(ht, gen)(*args, **kw), getattr(hp, gen)(*args, **kw)


@pytest.mark.parametrize("name", list(MATRICES))
def test_pack_bcsr_matches_reference(name):
    """Blocks, block rows and columns equal the JAX package's; brow_ptr
    delimits each block row's contiguous run."""
    from hisparse_tpu.ops.bcsr import pack_bcsr as ht_pack_bcsr
    m_r, m_p = _matrices(name)
    b_r, br_r, bc_r, meta_r = ht_pack_bcsr(m_r)
    blocks, brow, bcol, brow_ptr, meta = pack_bcsr(m_p)
    np.testing.assert_array_equal(blocks, np.asarray(b_r))
    np.testing.assert_array_equal(brow, np.asarray(br_r))
    np.testing.assert_array_equal(bcol, np.asarray(bc_r))
    assert meta == meta_r
    nbr = meta[0]
    assert brow_ptr.shape == (nbr + 1,) and brow_ptr[-1] == blocks.shape[0]
    np.testing.assert_array_equal(
        np.repeat(np.arange(nbr), np.diff(brow_ptr)), brow)


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_bcsr_matches_reference(name, dtype, k):
    import jax.numpy as jnp
    from hisparse_tpu.ops.bcsr import BcsrOperator as HtBcsr
    m_r, m_p = _matrices(name)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(k)
    X = rng.random((m_p.num_cols, k)).astype(np.float32)
    x = X[:, 0] if k == 1 else X
    y_ref = np.asarray(HtBcsr(m_r, dtype=jdt, interpret=True)(x))
    op = hp.BcsrOperator(m_p, tdt, device="cpu")
    y = op(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == y_ref.shape
    scale = max(float(np.abs(y_ref).max()), 1e-30)
    assert float(np.abs(y.numpy() - y_ref).max()) <= TOL * scale
    if name == "empty":
        assert (y == 0).all()


def test_bcsr_rounds_x_to_the_blocks_dtype():
    """A bf16 operator multiplies bf16-rounded blocks (duplicates summed
    first) by bf16-rounded x: the float64 product of the rounded operands,
    to fp32 sums' accuracy."""
    m = hp.powerlaw_csr(500, 700, 20, seed=6)
    X = np.random.default_rng(4).random((700, 3)).astype(np.float32)
    op = hp.BcsrOperator(m, torch.bfloat16, device="cpu")
    Y = op(torch.from_numpy(X)).numpy().astype(np.float64)
    rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()
    a = m.to_scipy().tocsr()
    a.sum_duplicates()
    a.data = rnd(a.data.astype(np.float32))
    ref = a @ rnd(X)
    assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()


def test_bcsr_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; on a device without a kernel it raises."""
    op = hp.BcsrOperator(hp.uniform_sparse_csr(300, 400, 40, seed=7),
                         device="cpu")
    xp = op.padded_x(torch.ones(400, 3))
    assert xp.shape == (op.nbc * BS, 8)
    before = _kernels.bcsr_launches
    out = bcsr_spmm(op.blocks, op.brow_ptr, op.bcol, xp)
    assert _kernels.bcsr_launches == before
    torch.testing.assert_close(
        out, bcsr_plain(op.blocks, op.brow_ptr, op.bcol, xp), rtol=0, atol=0)
    meta = [t.to("meta") for t in (op.blocks, op.brow_ptr, op.bcol, xp)]
    with pytest.raises(ValueError, match="no bcsr kernel"):
        bcsr_spmm(*meta)
    with pytest.raises(ValueError, match="expected"):
        op(torch.ones(401))
