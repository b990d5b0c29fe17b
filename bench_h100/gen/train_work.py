"""The work of one full-batch GCN training step, counted from the model's
widths and the normalized adjacency's entries alone, and the least time the
card could take for its sparse products.

A layer ``d_in -> d_out`` aggregates on its narrower side: ``(Â H) W``
when ``d_in <= d_out``, else ``Â (H W)`` (the same product, fewer sparse
operations).  Its backward runs ``Â^T G`` at the same width, except where
the first layer aggregates its input features, which take no gradient.
Each product of ``Â`` (nnz entries, self-loops counted) at width F is
2 nnz F operations; each projection is 2 N d_in d_out forward, as much
again for its weight gradient, and as much for the gradient of its input
in every layer but the first.  Bias, relu, dropout, the softmax and the
optimizer are left out: they are elementwise.
"""
from __future__ import annotations

from bench_h100.gen import work


def spmm_widths(dims) -> tuple[list, list]:
    """``(forward widths, backward widths)`` of the step's products of
    ``Â``, in the order they run."""
    fwd, bwd = [], []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        fwd.append(min(d_in, d_out))
        if i > 0 or d_out < d_in:
            bwd.append(min(d_in, d_out))
    return fwd, bwd[::-1]


def gemm_flops(num_nodes: int, dims) -> int:
    total = 0
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        one = 2 * num_nodes * d_in * d_out
        total += one * (3 if i > 0 else 2)
    return total


def spmm_ops(nnz: int, dims) -> int:
    """The step's sparse operations: every product of ``Â``, forward and
    backward."""
    fwd, bwd = spmm_widths(dims)
    return sum(work.csr_ops(nnz, f) for f in fwd + bwd)


def step_flops(num_nodes: int, nnz: int, dims) -> int:
    """The step's model operations: every product of ``Â`` and every
    projection, forward and backward."""
    return spmm_ops(nnz, dims) + gemm_flops(num_nodes, dims)


def spmm_bound_s(num_nodes: int, nnz: int, dims, peak: dict) -> float:
    """The least seconds the step's products of ``Â`` take on the card:
    ``work.bound_s`` of the CSR product at each width, summed."""
    fwd, bwd = spmm_widths(dims)
    return sum(work.bound_s(num_nodes, num_nodes, nnz, f, peak)
               for f in fwd + bwd)
