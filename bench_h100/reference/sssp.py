"""The plain reference of single-source shortest paths: Bellman-Ford in
plain PyTorch over the edges of the CSR matrix the benchmark made (row u
to column v at weight a_uv), in float64 unless told otherwise, to the
fixpoint.  It imports nothing of the program and takes nothing the program
made.

``rel_err`` is the number compared: the worst vertex's gap between the
program's distance and the reference's, over the reference's distance.
Vertices the reference cannot reach must come out at +inf and the source
at exactly 0; any other mismatch, or a NaN, is an infinite gap.
"""
from __future__ import annotations

import torch


class Graph:
    """The edges on a device, weights in ``dtype``."""

    def __init__(self, csr, device, dtype=torch.float64):
        indptr = torch.as_tensor(csr.indptr, dtype=torch.int64)
        self.n = csr.num_rows
        self.src = torch.repeat_interleave(
            torch.arange(csr.num_rows), indptr[1:] - indptr[:-1]).to(device)
        self.dst = torch.as_tensor(csr.indices, dtype=torch.int64,
                                   device=device)
        self.w = torch.as_tensor(csr.data, device=device).to(dtype)

    def distances(self, source: int):
        """Distances from ``source``, in the weights' dtype."""
        d = torch.full((self.n,), float("inf"), dtype=self.w.dtype,
                       device=self.w.device)
        d[source] = 0.0
        while True:
            nd = d.scatter_reduce(0, self.dst, d[self.src] + self.w, "amin")
            if not bool((nd < d).any()):
                return d
            d = nd


def rel_err(d, ref) -> float:
    d = d.to(ref.device, torch.float64)
    if d.shape != ref.shape:
        return float("inf")
    fin = torch.isfinite(ref)
    gap = torch.where(fin, (d - ref).abs(), torch.zeros_like(ref))
    err = torch.where(ref > 0, gap / ref.clamp_min(1e-300),
                      torch.where(gap == 0, 0.0, float("inf")))
    err = torch.where(fin | (d == ref), err, float("inf"))
    err = torch.where(torch.isnan(err), float("inf"), err)
    return float(err.max()) if err.numel() else 0.0
