"""Distributed graph apps over the mesh: the port of
``hisparse_tpu/parallel/apps.py``.

Each app row-shards its (semiring) matrix like :class:`~.mesh.
ShardedSpmv` and keeps its iterate in NATURAL order (unlike the
single-device apps of ``models/apps.py``, which chain in the renamed
space): the gathered vector means the same on every shard.  A step is,
per shard, the SpMV kernel on its rows, a fold of its renamed partials to
its natural rows, then one :func:`~.mesh.all_gather`.  The fold is the
operator's fixed-order ``row_fold`` (max_times rows with no partial at 0),
the JAX package's ``fold="scatter"``.  Its ``fold="combine"``, a 0/1
selection pack a shard run through the SpMV kernel, has no counterpart:
on the card it was slower than ``row_fold`` on every graph measured, and
its one selection level grows with the widest hub-split row (ROADMAP.md,
settled divergences).

The JAX package runs a whole app as one jit with a device loop.  Here the
loop runs on the host: PageRank enqueues its iterations without reading
anything back, SSSP reads one flag an iteration (did any distance fall),
BFS one an level (is the frontier empty), and the levels stay on the
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix, csr_to_csc, normalize_by_outdegree
from ..ops.spmv import SpmvOperator
from .mesh import Mesh, _pack_shards, all_gather
from .train import _row_shards


class _ShardedSemiringStep:
    """One mesh-wide step ``y = A (x) x`` over a row-sharded semiring
    pack: ``step(x_full) -> y_full``, both natural order, padded to
    ``n_devices * rows_per_shard``, on the first mesh device."""

    def __init__(self, m: CSRMatrix, mesh: Mesh, cfg: SpmvConfig,
                 split_max):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.cfg = cfg
        self.devices = mesh.device_list()
        self.n_devices = len(self.devices)
        subs, rps = _row_shards(m, self.n_devices)
        self.rows_per_shard = rps
        self.num_rows, self.num_cols = m.num_rows, m.num_cols
        self.packs = _pack_shards(subs, cfg, split_max)
        self.ops = [SpmvOperator(w, dev)
                    for w, dev in zip(self.packs, self.devices)]

    def local(self, d: int, x: torch.Tensor) -> torch.Tensor:
        """Shard d's natural rows of ``A (x) x`` on its device."""
        op = self.ops[d]
        return op(x[:self.num_cols].to(op.device))

    def step(self, x: torch.Tensor) -> torch.Tensor:
        parts = [self.local(d, x) for d in range(self.n_devices)]
        return all_gather(parts, 0, [x.device])[0]

    def zeros(self, fill: float = 0.0, dtype=torch.float32) -> torch.Tensor:
        """A full padded vector on the first mesh device."""
        return torch.full((self.n_devices * self.rows_per_shard,), fill,
                          dtype=dtype, device=self.devices[0])


class ShardedPageRank:
    """Power-iteration PageRank over the mesh: per iteration the sharded
    step (SpMV, fold, all_gather) and the damped update on the first mesh
    device.  Matches :func:`~..models.apps.pagerank_reference` and the
    single-device :class:`~..models.apps.PageRank`."""

    def __init__(self, adj: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None, damping: float = 0.85,
                 split_max="auto"):
        if adj.num_rows != adj.num_cols:
            raise ValueError("PageRank needs a square adjacency matrix")
        cfg = config or SpmvConfig()
        if cfg.semiring != "plus_times" or cfg.dtype == "fixed":
            raise ValueError("PageRank runs on the plus_times float path")
        self.n = adj.num_rows
        self.damping = damping
        m = normalize_by_outdegree(adj.astype(np.float32))
        self.st = _ShardedSemiringStep(m, mesh, cfg, split_max)
        self.valid = self.st.zeros()
        self.valid[:self.n] = 1.0

    def step(self, x: torch.Tensor) -> torch.Tensor:
        return (self.damping * self.st.step(x)
                + (1.0 - self.damping) / self.n * self.valid)

    def run(self, iters: int = 20, x0=None) -> torch.Tensor:
        """The PageRank vector in original row order, on the first mesh
        device."""
        x = self.st.zeros()
        x[:self.n] = (1.0 / self.n if x0 is None
                      else torch.as_tensor(x0, dtype=torch.float32))
        for _ in range(iters):
            x = self.step(x)
        return x[:self.n]


class ShardedSSSP:
    """Bellman-Ford (min, +) over the mesh on the transposed matrix (y[v]
    folds over in-edges, as the single-device
    :class:`~..models.apps.SSSP`), stopping as soon as no distance falls:
    one host read an iteration, O(diameter) iterations."""

    def __init__(self, adj: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None, split_max="auto"):
        if adj.num_rows != adj.num_cols:
            raise ValueError("SSSP needs a square weighted adjacency matrix")
        cfg = dataclasses.replace(config or SpmvConfig(), semiring="min_plus",
                                  dtype="fp32", steal_mantissa=False)
        self.n = adj.num_rows
        self.st = _ShardedSemiringStep(csr_to_csc(adj.astype(np.float32)),
                                       mesh, cfg, split_max)

    def run(self, source: int, iters: int | None = None) -> torch.Tensor:
        """Distances from ``source`` in original row order (inf =
        unreachable), on the first mesh device; ``iters_run`` counts the
        iterations, the last one (which changed nothing) included."""
        iters = iters if iters is not None else self.n - 1
        d = self.st.zeros(float("inf"))
        d[source] = 0.0
        it, changed = 0, True
        while changed and it < iters:
            d2 = torch.minimum(d, self.st.step(d))
            changed = bool((d2 < d).any())
            d, it = d2, it + 1
        self.iters_run = it
        return d[:self.n]


class ShardedBFS:
    """Frontier BFS (max, times on 0/1 weights) over the mesh, the levels
    kept on the device and one host read a level (is the frontier
    empty)."""

    def __init__(self, adj: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None, split_max="auto"):
        cfg = dataclasses.replace(config or SpmvConfig(), semiring="max_times",
                                  dtype="fp32", steal_mantissa=False)
        self.n = adj.num_rows
        at = csr_to_csc(adj)
        at = CSRMatrix(at.num_rows, at.num_cols,
                       np.ones(at.nnz, np.float32), at.indices, at.indptr)
        self.st = _ShardedSemiringStep(at, mesh, cfg, split_max)

    def run(self, source: int, max_iters: int | None = None) -> torch.Tensor:
        """BFS level of each node in original row order (-1 =
        unreachable), int64 on the first mesh device."""
        max_iters = max_iters if max_iters is not None else self.n
        frontier = self.st.zeros()
        frontier[source] = 1.0
        reached = frontier.clone()
        level = self.st.zeros(-1, torch.int64)
        level[source] = 0
        it = 1
        while it <= max_iters and bool((frontier > 0).any()):
            hit = self.st.step(frontier) > 0
            newly = hit & ~(reached > 0)
            level = torch.where(newly, it, level)
            reached = torch.maximum(reached, hit.to(reached.dtype))
            frontier = newly.to(frontier.dtype)
            it += 1
        return level[:self.n]
