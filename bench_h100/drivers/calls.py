"""Closed loop, one client: calls of ``SpmvOperator.forward(x)`` or
``SpmvOperator.matmul(X)`` on one packed matrix, each waited for, as a
solver or a GNN layer waits for its product.

The traffic file gives ``entry`` (``forward`` or ``matmul``),
``features`` (1 for ``forward``), ``pool`` (how many seeded inputs are
cycled) and ``trace_requests`` (the calls of the traced stretch).  The
configuration's ``spmv_config`` and ``pack`` are what a user passes to
``pack``.
"""
from __future__ import annotations

import time

import torch

from bench_h100.gen import work
from bench_h100.gen.matrices import generator
from bench_h100.reference import spmv as ref_spmv


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stopwatch:
    """Times a request from the call into the program to the synchronize
    after it.  On the card two CUDA events bracket it, read on the device's
    clock: the host's clock jitters by a good part of a millisecond, more
    than a call takes.  The first event runs as soon as it is recorded (the
    stream is empty after the last synchronize), the second after the
    request's last kernel, so the time holds every wait of the device on
    the host's enqueue.  On the CPU (the tests) the host clock serves."""

    def __init__(self, device):
        self.device = device
        if device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def time(self, fn):
        """``(fn(), enqueue seconds, request seconds)``; the enqueue is the
        host's time from entering ``fn`` to its return."""
        cuda = self.device.type == "cuda"
        if cuda:
            self.events[0].record()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        if not cuda:
            return out, t1 - t0, t1 - t0
        self.events[1].record()
        sync(self.device)
        return out, t1 - t0, self.events[0].elapsed_time(self.events[1]) / 1e3


class Cell:
    def __init__(self, config: dict, traffic: dict, csr, seed: int,
                 device):
        self.config, self.traffic, self.csr = config, traffic, csr
        self.device = torch.device(device)
        self.entry = traffic["entry"]
        self.features = int(traffic["features"])
        if self.entry == "forward" and self.features != 1:
            raise ValueError("forward takes one feature")
        shape = (traffic["pool"], csr.num_cols)
        if self.entry == "matmul":
            shape += (self.features,)
        self.pool = torch.rand(shape, generator=generator(
            seed, "inputs", self.device), device=self.device)
        self.op = None
        self.watch = Stopwatch(self.device)

    def prepare(self) -> None:
        """From the CSR matrix in host memory to an operator on the card:
        the pack, its plans and the upload."""
        from hisparse_tpu_torch import CSRMatrix, SpmvConfig, SpmvOperator
        from hisparse_tpu_torch.formats.wavepack import pack
        c = self.csr
        m = CSRMatrix(c.num_rows, c.num_cols, c.data, c.indices, c.indptr)
        self.wp = pack(m, SpmvConfig(**self.config["spmv_config"]),
                       **self.config["pack"])
        self.op = SpmvOperator(self.wp, self.device)
        self.call = getattr(self.op, self.entry)
        sync(self.device)

    def counters(self) -> dict:
        return {"fill": self.wp.fill, "main_tiles": self.wp.num_tiles}

    def request(self, i: int):
        """One call, waited for: ``(key, output, ops, enqueue seconds,
        seconds)``."""
        key = i % self.pool.shape[0]
        y, enq, secs = self.watch.time(lambda: self.call(self.pool[key]))
        return key, y, work.csr_ops(self.csr.nnz, self.features), enq, secs

    def bound_s(self, peak: dict, requests) -> float:
        """The least seconds the card could take for ``requests``."""
        c = self.csr
        return len(requests) * work.bound_s(c.num_rows, c.num_cols, c.nnz,
                                            self.features, peak)

    def warm_up(self) -> None:
        for i in range(self.pool.shape[0]):
            self.request(i)

    def release(self) -> None:
        self.op = self.call = self.wp = None

    def check(self, samples) -> list:
        """``rel_err`` of each kept ``(key, output)`` pair."""
        ref = ref_spmv.CsrF64(self.csr, self.device)
        errs, cache = [], {}
        for key, y in samples:
            if key not in cache:
                cache[key] = ref.apply(self.pool[key])
            errs.append(ref_spmv.rel_err(y, *cache[key]))
        return errs
