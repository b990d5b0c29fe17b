"""The plain reference of y = A x and Y = A X: plain PyTorch in float64,
from the CSR matrix the benchmark made and the inputs it handed the
program.  It imports nothing of the program and takes nothing the program
made.

``rel_err`` is the number compared: for every row, the gap between the
program's y and the reference's, over the row's sum of |a| |x| (the size
its rounding scales with), worst row and feature.  A row whose sum of
|a| |x| is 0 must come out exactly at the reference's value; a NaN counts
as an infinite gap.
"""
from __future__ import annotations

import torch

# nonzeros a block of the reference takes at once
BLOCK_NNZ = 1 << 23


class CsrF64:
    """The matrix on a device in float64, row ids spelt out."""

    def __init__(self, csr, device, values=None):
        self.num_rows, self.num_cols = csr.num_rows, csr.num_cols
        indptr = torch.as_tensor(csr.indptr, dtype=torch.int64)
        self.rows = torch.repeat_interleave(
            torch.arange(csr.num_rows), indptr[1:] - indptr[:-1]).to(device)
        self.cols = torch.as_tensor(csr.indices, dtype=torch.int64,
                                    device=device)
        data = csr.data if values is None else values
        self.data = torch.as_tensor(data, device=device).to(torch.float64)

    def apply(self, X):
        """``(A X, |A| |X|)`` in float64 for X of (cols,) or (cols, F)."""
        X = X.to(self.data.device, torch.float64)
        vec = X.dim() == 1
        X = X.reshape(self.num_cols, -1)
        y = torch.zeros(self.num_rows, X.shape[1], dtype=torch.float64,
                        device=X.device)
        mag = torch.zeros_like(y)
        for s in range(0, self.data.numel(), BLOCK_NNZ):
            cols = self.cols[s:s + BLOCK_NNZ]
            rows = self.rows[s:s + BLOCK_NNZ]
            t = self.data[s:s + BLOCK_NNZ, None] * X[cols]
            y.index_add_(0, rows, t)
            mag.index_add_(0, rows, t.abs())
        return (y[:, 0], mag[:, 0]) if vec else (y, mag)


def rel_err(y, ref, mag) -> float:
    """The worst row's gap ``|y - ref| / sum |a| |x|`` (0 where both are
    exactly equal; infinite for a NaN or a gap in a row of magnitude 0)."""
    y = y.to(ref.device, torch.float64)
    if y.shape != ref.shape:
        return float("inf")
    gap = (y - ref).abs()
    err = torch.where(mag > 0, gap / mag.clamp_min(1e-300),
                      torch.where(gap == 0, 0.0, float("inf")))
    err = torch.where(torch.isnan(err), float("inf"), err)
    return float(err.max()) if err.numel() else 0.0
