"""Closed loop, one client: graph queries, ``SSSP.run(source)`` to the
fixpoint, each waited for until its distances are on the device.

The traffic file gives ``sources`` (how many sources are drawn, among
vertices with at least one out-edge), ``warm_up`` queries,
``trace_requests`` (the queries of the traced stretch) and ``masked``
(default false): ``SSSP.run(source, masked=True)``, sparse
Bellman-Ford, streams only the tiles the last step's changed distances
can touch.  The set of sources is drawn from the configuration's
structure seed, so that every run asks the same queries; the run's seed
sets their order, a new order each pass over the set.  A query's work (its iterations) follows the edge
weights, so they too are the graph's, drawn from the structure seed in
place of the run's: with weights from the run's seed, the tail moved with
the seed far more than between two runs of one seed.  A window holds several passes, so that every
seed's window holds nearly the same queries: a set larger than a window
would leave a different part of it out at each seed, and its tail would
move with the seed.  The
configuration's ``spmv_config`` is what the user passes to ``SSSP``, which
sets its own semiring and value type.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_h100.gen import work
from bench_h100.gen.matrices import generator, subseed
from bench_h100.reference import sssp as ref_sssp

from .calls import Stopwatch, sync


# passes over the set of sources drawn ahead, more than a window holds
PASSES = 64


class Cell:
    def __init__(self, config: dict, traffic: dict, csr, seed: int,
                 device):
        self.config, self.traffic, self.csr = config, traffic, csr
        self.device = torch.device(device)
        csr.data = torch.rand(csr.nnz, generator=generator(
            config["generator"]["structure_seed"], "weights", self.device),
            device=self.device).cpu().numpy()
        has_edges = np.flatnonzero(csr.row_nnz() > 0)
        chosen = np.random.default_rng(subseed(
            config["generator"]["structure_seed"], "sources")).choice(
            has_edges, int(traffic["sources"]), replace=False)
        rng = np.random.default_rng(subseed(seed, "sources"))
        self.sources = np.concatenate([rng.permutation(chosen)
                                       for _ in range(PASSES)])
        self.masked = bool(traffic.get("masked", False))
        self.app = None
        self.watch = Stopwatch(self.device)

    def prepare(self) -> None:
        """From the CSR matrix in host memory to an app on the card: the
        transpose, its pack, the plan of the fold into rank order and the
        upload."""
        from hisparse_tpu_torch import CSRMatrix, SpmvConfig
        from hisparse_tpu_torch.models.apps import SSSP
        c = self.csr
        m = CSRMatrix(c.num_rows, c.num_cols, c.data, c.indices, c.indptr)
        self.app = SSSP(m, SpmvConfig(**self.config["spmv_config"]),
                        device=self.device)
        sync(self.device)

    def counters(self) -> dict:
        return {"fill": self.app.wp.fill,
                "main_tiles": self.app.wp.num_tiles}

    def request(self, i: int):
        """One query, waited for: ``(key, output, ops, enqueue seconds,
        seconds)``; the key is ``(source, iterations)``, and a masked
        query's ``(source, iterations, tiles streamed)``.  Its operations
        are 2 nnz an iteration, masked or not."""
        src = int(self.sources[i % len(self.sources)])
        d, enq, secs = self.watch.time(
            lambda: self.app.run(src, masked=self.masked))
        iters = self.app.iters_run
        key = (src, iters)
        if self.masked:
            key += (sum(self.app.tiles_streamed),)
        return key, d, work.csr_ops(self.csr.nnz) * iters, enq, secs

    def bound_s(self, peak: dict, requests) -> float:
        c = self.csr
        one = work.bound_s(c.num_rows, c.num_cols, c.nnz, 1, peak)
        return one * sum(key[1] for key in requests)

    def warm_up(self) -> None:
        for i in range(int(self.traffic["warm_up"])):
            self.request(len(self.sources) - 1 - i)

    def release(self) -> None:
        self.app = None

    def check(self, samples) -> list:
        """``rel_err`` of each kept ``(key, distances)``; the key starts
        with the source."""
        g = ref_sssp.Graph(self.csr, self.device)
        return [ref_sssp.rel_err(d, g.distances(key[0]))
                for key, d in samples]


def size_of(key) -> int:
    """A query's size, its iterations: the longest is always checked."""
    return key[1]
