"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

  * ``configs/<config>.json``: the generator and its frozen structure
    seed, and what the user passes to the program;
  * ``traffic/<traffic>.json``: the ``driver`` (a module of ``drivers/``)
    and its parameters;
  * ``metrics/<metric>.py``: ``read(rec)``, the metric from the run's
    record, or None where it finds nothing to read;
  * ``limits/<workload>.json``: each compared number's limit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from bench_h100.gen import matrices, work

BENCH = os.path.dirname(os.path.abspath(__file__))
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "hisparse_tpu")
# answers kept from a window for the check
SAMPLES = 8


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """A cell as ``BENCHMARK.json`` and the files it names describe it."""

    def __init__(self, workload: str, manifest: dict, bench: str = BENCH):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.cell = cells[workload]
        self.bench = bench
        self.config = load_json(os.path.join(
            bench, "configs", f"{self.cell['config']}.json"))
        self.traffic = load_json(os.path.join(
            bench, "traffic", f"{self.cell['traffic']}.json"))
        self.limits = load_json(os.path.join(
            bench, "limits", f"{workload}.json"))

        def mine(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]

    def driver(self):
        return importlib.import_module(
            f"bench_h100.drivers.{self.traffic['driver']}")

    def reader(self, metric: str):
        path = os.path.join(self.bench, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"bench_h100_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Reservoir:
    """A uniform sample of ``k`` answers from a stream of unknown length
    (Algorithm R, drawn from the run's seed), and the answer whose
    ``size(key)`` is largest."""

    def __init__(self, k: int, seed: int, size=None):
        self.k, self.size = k, size
        self.rng = np.random.default_rng(matrices.subseed(seed, "sample"))
        self.kept, self.seen, self.largest = [], 0, None

    def offer(self, key, out) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((key, out))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = (key, out)
        if self.size is not None and (self.largest is None or self.size(
                key) > self.size(self.largest[0])):
            self.largest = (key, out)

    def samples(self):
        out = list(self.kept)
        if self.largest is not None and all(
                k is not self.largest[0] for k, _ in out):
            out.append(self.largest)
        return out


def forbidden_modules(modules=None) -> list:
    """The names of ``FORBIDDEN`` that a module held by the process has as
    its top-level name (the part before the first dot, whole)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _window(cell, seconds: float, sample: Reservoir):
    durations, keys, ops = [], [], 0
    i = 0
    start = time.perf_counter()
    while True:
        key, out, n_ops, _, secs = cell.request(i)
        t1 = time.perf_counter()
        durations.append(secs)
        keys.append(key)
        ops += n_ops
        sample.offer(key, out)
        i += 1
        if t1 - start >= seconds:
            break
    return start, {"durations_s": durations, "keys": keys, "ops": ops,
                   "window_s": t1 - start, "requests": i}


def _traced(cell, n: int, sample: Reservoir, device):
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench_h100 import trace
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    keys, enqueue = [], []
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            for i in range(n):
                with record_function(trace.REQUEST):
                    key, out, _, enq, _ = cell.request(i)
                keys.append(key)
                enqueue.append(enq)
                sample.offer(key, out)
    rec = trace.read(prof)
    rec.update(keys=keys, enqueue_s=enqueue, requests=n)
    return rec


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool,
             device, t_process: float | None = None,
             cell_type=None) -> dict:
    """Run the cell once; the result line's fields, ``compared`` last.
    ``cell_type`` replaces the driver's ``Cell`` (the control does)."""
    device = torch.device(device)
    t_process = time.perf_counter() if t_process is None else t_process
    if device.type == "cuda":
        from hisparse_tpu_torch.formats import native
        from hisparse_tpu_torch.ops import _kernels
        if not native.available():
            raise RuntimeError("the native packer did not build")
        _kernels.load()
    csr = matrices.make(spec.config["generator"], seed, device)
    driver = spec.driver()
    cell = (cell_type or driver.Cell)(spec.config, spec.traffic, csr, seed,
                                      device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cell.prepare()
    prepare_s = time.perf_counter() - t0
    counters = cell.counters()
    cell.warm_up()
    sample = Reservoir(SAMPLES, seed, getattr(driver, "size_of", None))
    if traced:
        rec = _traced(cell, int(spec.traffic["trace_requests"]), sample,
                      device)
    else:
        start, rec = _window(cell, seconds, sample)
        rec.update(setup_s=start - t_process)
    # the prepare runs before any profiler starts: untraced either way
    rec.update(driver=spec.traffic["driver"], counters=counters,
               prepare_s=prepare_s)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if traced and device.type == "cuda":
        rec["bound_s"] = cell.bound_s(work.peaks(kind), rec["keys"])
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if traced:
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    metrics = {}
    for m in (spec.per_layer if traced else spec.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, once the window has closed and the program's state is
    # freed
    samples = sample.samples()
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    errs = cell.check(samples)
    limit = float(spec.limits["max_rel_err"])
    worst = max(errs, default=float("inf"))
    out = {"correct": bool(samples) and worst <= limit,
           "attempted": rec["requests"],
           "failed": sum(e > limit for e in errs),
           "metrics": metrics, "device": dev}
    if traced and rec.get("breakdown"):
        out["breakdown"] = rec["breakdown"]
    out["cell"] = dict(counters, nnz=csr.nnz, num_rows=csr.num_rows,
                       num_cols=csr.num_cols)
    out["compared"] = {"max_rel_err": {"value": worst, "limit": limit}}
    return out
