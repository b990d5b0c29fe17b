"""BCSR (block-sparse rows): dense (128, 128) blocks on the tensor cores,
the port of ``hisparse_tpu/ops/bcsr.py``.

The middle regime between wavepack (unstructured, gathered) and the fully
dense path: matrices whose nonzeros cluster into dense-ish tiles (the
SpMM batch config of BASELINE.json, "Multi-vector SpMM batch on BCSR tiles
(dense-block MXU path, x with 64 cols)").  Each stored block is a dense
(128, 128) tile; ``bcsr_spmm`` multiplies every block against the x rows
of its block column and accumulates into its block row's output, in fp32:
the CUDA kernel of ``csrc/bcsr.cu`` on CUDA tensors (bf16 blocks on the
tensor cores, fp32 blocks with FFMA), the plain PyTorch version
``bcsr_plain`` on CPU tensors.

GOPS still counts 2*nnz(A)/t of the true nonzeros, so comparisons with
the sparse paths stay honest.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from . import _kernels

BS = 128  # block edge


def pack_bcsr(m: CSRMatrix):
    """Densify the nonempty (128, 128) blocks of a CSR matrix, on the host.

    Returns ``(blocks, brow, bcol, brow_ptr, (nbr, nbc, nnz))``: blocks a
    float32 (nb, 128, 128) array with duplicates summed, block ids sorted by
    (brow, bcol), and ``brow_ptr`` (nbr + 1) so that block row r's blocks
    are the contiguous run ``brow_ptr[r] .. brow_ptr[r + 1]``.  A matrix
    without nonzeros keeps one zero block at (0, 0), as the JAX package's
    does."""
    nbr = -(-m.num_rows // BS)
    nbc = -(-m.num_cols // BS)
    rows = np.repeat(np.arange(m.num_rows), m.row_nnz())
    br = rows // BS
    bc = m.indices // BS
    key = br.astype(np.int64) * nbc + bc
    uniq, inv = np.unique(key, return_inverse=True)
    nb = uniq.size
    blocks = np.zeros((max(nb, 1), BS, BS), np.float32)
    # duplicates sum (SpMV semantics)
    np.add.at(blocks, (inv, rows % BS, m.indices % BS), m.data)
    brow = (uniq // nbc).astype(np.int32)
    bcol = (uniq % nbc).astype(np.int32)
    if nb == 0:
        brow = np.zeros(1, np.int32)
        bcol = np.zeros(1, np.int32)
    brow_ptr = np.searchsorted(brow, np.arange(nbr + 1)).astype(np.int32)
    return blocks, brow, bcol, brow_ptr, (nbr, nbc, m.nnz)


def bcsr_plain(blocks, brow_ptr, bcol, x) -> torch.Tensor:
    """Plain PyTorch version of the BCSR kernel: ``torch.bmm`` of the
    blocks (as float32) against the x blocks they read, then ``index_add_``
    by block row.  ``x`` (nbc*128, k) is of the blocks' dtype; returns the
    (nbr*128, k) float32 product.  A bf16 product of two values is exact in
    float32, so only the order of the sums differs from the kernel (and on
    CUDA, ``index_add_`` adds a block row's blocks in no fixed order; a
    float32 ``bmm`` there follows ``torch.backends.cuda.matmul.allow_tf32``,
    which must be False for an fp32 reference)."""
    nbr, k = brow_ptr.shape[0] - 1, x.shape[1]
    brow = torch.repeat_interleave(
        torch.arange(nbr, device=blocks.device),
        (brow_ptr[1:] - brow_ptr[:-1]).long())
    xb = x.to(torch.float32).reshape(-1, BS, k)[bcol.long()]
    out = torch.zeros(nbr, BS, k, dtype=torch.float32, device=blocks.device)
    out.index_add_(0, brow, torch.bmm(blocks.to(torch.float32), xb))
    return out.reshape(nbr * BS, k)


def bcsr_spmm(blocks, brow_ptr, bcol, x) -> torch.Tensor:
    """``(nbr*128, kp)`` float32 = A @ x over the stored blocks: ``blocks``
    (nb, 128, 128) bf16 or float32, ``brow_ptr`` (nbr + 1) and ``bcol``
    (nb) int32 (:func:`pack_bcsr`), ``x`` (nbc*128, kp) of the blocks'
    dtype with kp a multiple of 8 (the kernel loads 16 B of a row at once).

    On CUDA tensors this launches ``csrc/bcsr.cu``; on CPU tensors it runs
    :func:`bcsr_plain`.  The kernel trusts ``brow_ptr`` and ``bcol`` to
    index the blocks and x; this wrapper checks device, dtype, shape and
    contiguity."""
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bcsr kernel for {blocks.device}")
    if blocks.device.type == "cpu":
        return bcsr_plain(blocks, brow_ptr, bcol, x)
    if blocks.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bcsr_spmm: blocks of {blocks.dtype}; bf16 or "
                         "float32 only")
    if (blocks.dim() != 3 or tuple(blocks.shape[1:]) != (BS, BS)
            or x.dim() != 2 or x.shape[0] % BS or x.shape[1] % 8
            or x.shape[1] < 8):
        raise ValueError("bcsr_spmm: blocks must be (nb, 128, 128) and x "
                         "(nbc*128, kp) with kp a positive multiple of 8")
    for t, dtype, shape in ((x, blocks.dtype, x.shape),
                            (brow_ptr, torch.int32, brow_ptr.shape),
                            (bcol, torch.int32, (blocks.shape[0],))):
        if t.device != blocks.device or t.dtype != dtype or tuple(
                t.shape) != tuple(shape):
            raise ValueError(f"bcsr_spmm: operand {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, expected "
                             f"{tuple(shape)} {dtype} on {blocks.device}")
    if not all(t.is_contiguous() for t in (blocks, brow_ptr, bcol, x)):
        raise ValueError("bcsr_spmm operands must be contiguous")
    if blocks.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("bcsr_spmm: blocks and x must be 16-byte aligned "
                         "(the kernel loads them in 16-byte units)")
    nbr = brow_ptr.shape[0] - 1
    out = torch.empty(nbr * BS, x.shape[1], dtype=torch.float32,
                      device=blocks.device)
    if nbr:
        _kernels.launch_bcsr(blocks, brow_ptr, bcol, x, out)
    return out


class BcsrOperator(torch.nn.Module):
    """y = A @ x (or Y = A @ X with k right-hand sides) over dense-block
    BCSR storage (the port of ``hisparse_tpu.ops.bcsr.BcsrOperator``).

    ``dtype`` is the blocks' type, ``torch.float32`` or ``torch.bfloat16``;
    x is cast to it first, as the JAX package's ``_bcsr_call`` does, so a
    bf16 operator rounds x to bf16 too.  The sums are fp32 and so is y.
    The operator lives on ``device``, the card unless the caller asks for
    the CPU."""

    def __init__(self, m: CSRMatrix, dtype=torch.float32, device="cuda"):
        super().__init__()
        blocks, _, bcol, brow_ptr, (self.nbr, self.nbc, self.nnz) = \
            pack_bcsr(m)
        self.num_rows, self.num_cols = m.num_rows, m.num_cols
        self.device = torch.device(device)

        def buf(a):
            return torch.from_numpy(a).to(self.device)

        self.register_buffer(
            "blocks", torch.from_numpy(blocks).to(dtype).to(self.device))
        self.register_buffer("bcol", buf(bcol))
        self.register_buffer("brow_ptr", buf(brow_ptr))
        self.stream_bytes = self.blocks.numel() * self.blocks.element_size()

    @property
    def block_fill(self) -> float:
        return self.nnz / max(self.blocks.numel(), 1)

    def padded_x(self, x) -> torch.Tensor:
        """x (num_cols,) or (num_cols, k) -> the (nbc*128, kp) operand of
        :func:`bcsr_spmm`, cast to the blocks' dtype, kp = k rounded up to
        a multiple of 8, zeros elsewhere."""
        x = torch.as_tensor(x, device=self.device)
        if x.dim() == 1:
            x = x[:, None]
        if x.dim() != 2 or x.shape[0] != self.num_cols:
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.num_cols},) or ({self.num_cols}, k)")
        kp = max(8, -(-x.shape[1] // 8) * 8)
        xp = torch.zeros(self.nbc * BS, kp, dtype=self.blocks.dtype,
                         device=self.device)
        xp[:self.num_cols, :x.shape[1]] = x.to(self.blocks.dtype)
        return xp

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        out = bcsr_spmm(self.blocks, self.brow_ptr, self.bcol,
                        self.padded_x(x))
        out = out[:self.num_rows]
        return out[:, 0] if x.dim() == 1 else out[:, :x.shape[1]]
