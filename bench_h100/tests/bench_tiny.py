"""A copy of the benchmark at a size the CPU tests can hold: the same files,
with each configuration's matrix cut to a few thousand rows, its packs to
128-sublane tiles, and each traffic mix's pool and traced stretch to a
few requests.  The limits are the benchmark's own."""
from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness  # noqa: E402

TINY_ROWS = 2000
TINY_PACK = dict(sublanes=128, stripes=128, bank_blocks=1)


def _edit(path: str, fn) -> None:
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f)


def manifest() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_bench(dest) -> str:
    """Copy ``bench_h100`` into ``dest`` at the tiny size; returns it."""
    bench = os.path.join(str(dest), "bench")
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def config(c):
        g = c["generator"]
        g["nnz"] = int(TINY_ROWS * min(g["nnz"] / g["num_rows"], 12))
        g["num_rows"] = g["num_cols"] = TINY_ROWS
        c["spmv_config"].update(TINY_PACK)

    def traffic(t):
        t.update(trace_requests=2)
        if "pool" in t:
            t["pool"] = 2
        if "warm_up" in t:
            t["warm_up"] = 1

    for name in os.listdir(os.path.join(bench, "configs")):
        _edit(os.path.join(bench, "configs", name), config)
    for name in os.listdir(os.path.join(bench, "traffic")):
        _edit(os.path.join(bench, "traffic", name), traffic)
    return bench


def run(bench: str, workload: str, seed: int = 3, traced: bool = False,
        man: dict | None = None, cell_type=None) -> dict:
    spec = harness.Spec(workload, man or manifest(), bench)
    return harness.run_cell(spec, seed, 0.2, traced, "cpu",
                            cell_type=cell_type)
