"""CPU tests of the benchmark's harness: discovery by file, the work
arithmetic, the reductions, the reference, and the refusal to run without
a card.  Run from the repository's root:

    python -m pytest bench_h100/tests -q

Tests marked ``cuda`` need the card and skip here."""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from bench_tiny import ROOT, manifest, run, tiny_bench

from bench_h100 import harness
from bench_h100.drivers import calls
from bench_h100.gen import matrices, stats, work
from bench_h100.reference import spmv as ref_spmv
from bench_h100.reference import sssp as ref_sssp

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_csr(kind="powerlaw", seed=5, n=600):
    spec = {"powerlaw": dict(kind="powerlaw", num_rows=n, num_cols=n,
                             nnz=9 * n, alpha=1.2, structure_seed=7),
            "rmat": dict(kind="rmat", num_rows=n, num_cols=n, nnz=6 * n,
                         structure_seed=7)}[kind]
    return matrices.make(spec, seed, "cpu")


def to_scipy(c):
    return sp.csr_matrix((c.data.astype(np.float64), c.indices, c.indptr),
                         shape=(c.num_rows, c.num_cols))


def test_config_traffic_and_metric_added_as_files(tmp_path):
    bench = tiny_bench(tmp_path)
    with open(os.path.join(bench, "configs", "ring.json"), "w") as f:
        json.dump({"name": "ring", "source": "a test",
                   "generator": {"kind": "rmat", "num_rows": 1500,
                                 "num_cols": 1500, "nnz": 7500,
                                 "structure_seed": 3},
                   "dtype": "fp32",
                   "spmv_config": {"sublanes": 128, "stripes": 128,
                                   "bank_blocks": 1},
                   "pack": {"split_max": 16},
                   "assumed": [], "reduced": []}, f)
    with open(os.path.join(bench, "traffic", "spmm4.json"), "w") as f:
        json.dump({"driver": "calls", "entry": "matmul", "features": 4,
                   "pool": 3, "trace_requests": 2}, f)
    with open(os.path.join(bench, "metrics", "calls_done.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec['requests'])\n")
    with open(os.path.join(bench, "limits", "ring-spmm4.json"), "w") as f:
        json.dump({"max_rel_err": 1e-4}, f)
    man = manifest()
    man["configs"].append({"name": "ring", "source": "a test",
                           "file": "bench/configs/ring.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "ring-spmm4", "config": "ring",
                             "traffic": "spmm4", "chips": 1,
                             "why": "a test"})
    man["end_to_end"].append({"name": "calls_done", "unit": "calls",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["ring-spmm4"]})
    r = run(bench, "ring-spmm4", man=man)
    assert r["correct"], r["compared"]
    assert r["metrics"]["calls_done"]["value"] == r["attempted"] >= 1
    assert set(r["metrics"]) == {"calls_done", "setup_s"}
    assert list(r)[-1] == "compared"


def test_roofline_bound_is_the_csr_matrix():
    c = tiny_csr("powerlaw")
    peak = work.PEAKS["NVIDIA H100 80GB HBM3"]
    bounds, streams = [], []
    for cfg, pk in (({"sublanes": 128, "stripes": 128, "bank_blocks": 1},
                     {}),
                    ({"sublanes": 256, "stripes": 128, "bank_blocks": 2,
                      "block_major": True, "classes_per_group": 2,
                      "steal_mantissa": True, "idx16": True,
                      "two_choice": False},
                     {"split_max": 8, "col_order": "degree"})):
        cell = calls.Cell({"spmv_config": cfg, "pack": pk},
                          {"entry": "forward", "features": 1, "pool": 2},
                          c, 1, "cpu")
        cell.prepare()
        streams.append(cell.wp.stream_bytes)
        bounds.append(cell.bound_s(peak, [0, 1, 0]))
    assert streams[0] != streams[1]
    assert bounds[0] == bounds[1]
    nbytes = (c.nnz * 8 + (c.num_rows + 1) * 4 + c.num_cols * 4
              + c.num_rows * 4)
    assert bounds[0] == 3 * max(nbytes / 3350e9, 2 * c.nnz / 67e12)
    assert work.csr_bytes(10, 20, 30, 4) == 30 * 8 + 11 * 4 + 80 * 4 + 40 * 4


def test_idle_union_over_overlapping_intervals():
    ivs = [(0.0, 4.0, "a"), (2.0, 6.0, "b"), (5.0, 7.0, "c"),
           (9.0, 10.0, "d"), (9.5, 9.7, "e")]
    assert stats.union(ivs) == [(0.0, 7.0), (9.0, 10.0)]
    assert stats.covered(ivs) == 8.0
    assert stats.covered(ivs, 1.0, 9.5) == 6.5
    assert stats.gaps(ivs, -1.0, 12.0) == [(-1.0, 0.0), (7.0, 9.0),
                                           (10.0, 12.0)]
    rec = {"driver": "calls", "busy_s": stats.covered(ivs) * 1e-6,
           "window_s": 12e-6}
    spec = harness.Spec("googleplus-spmv", manifest())
    assert spec.reader("idle_pct.call.googleplus")(rec) == pytest.approx(
        100 * (1 - 8 / 12))
    assert spec.reader("idle_pct.query")(rec) is None


def test_p95_over_all_samples():
    vals = [1.0] * 95 + [10.0] * 5
    assert stats.p95(vals) == pytest.approx(9.55)
    assert stats.p95(vals) == statistics.quantiles(vals, n=20)[-1]
    assert stats.p95(vals[::-1]) == stats.p95(vals)
    # one more slow sample moves it: every sample counts
    assert stats.p95(vals + [10.0]) > stats.p95(vals)
    assert stats.p95([3.0]) == 3.0
    spec = harness.Spec("googleplus-spmv", manifest())
    assert spec.reader("call_ms_p95.googleplus")(
        {"driver": "calls", "durations_s": [v * 1e-3 for v in vals]}) == \
        pytest.approx(9.55)


@pytest.mark.parametrize("kind", ["powerlaw", "rmat"])
def test_reference_against_scipy(kind):
    c = tiny_csr(kind)
    m = to_scipy(c)
    rng = np.random.default_rng(0)
    x = rng.random(c.num_cols)
    X = rng.random((c.num_cols, 3))
    ref = ref_spmv.CsrF64(c, "cpu")
    y, mag = ref.apply(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), m @ x, rtol=1e-12)
    np.testing.assert_allclose(mag.numpy(), abs(m) @ abs(x), rtol=1e-12)
    Y, _ = ref.apply(torch.from_numpy(X))
    np.testing.assert_allclose(Y.numpy(), m @ X, rtol=1e-12)
    assert ref_spmv.rel_err(y.float(), y, mag) < 1e-6
    if kind != "rmat":
        return      # scipy's graphs sum duplicate edges; R-MAT has none
    g = ref_sssp.Graph(c, "cpu")
    for src in (0, int(np.argmax(c.row_nnz()))):
        d = g.distances(src).numpy()
        np.testing.assert_allclose(d, csgraph.dijkstra(m, indices=src),
                                   rtol=1e-12)


def test_rel_err_finds_each_kind_of_gap():
    ref = torch.tensor([1.0, 2.0, 0.0, float("inf")], dtype=torch.float64)
    d = ref.clone()
    assert ref_sssp.rel_err(d, ref) == 0.0
    for i, v in ((0, 1.5), (2, 1e-30), (3, 5.0), (1, float("nan"))):
        bad = ref.clone()
        bad[i] = v
        assert ref_sssp.rel_err(bad, ref) > 1e-3
    y = torch.tensor([1.0, 0.0])
    mag = torch.tensor([2.0, 0.0], dtype=torch.float64)
    r = torch.tensor([1.0, 0.0], dtype=torch.float64)
    assert ref_spmv.rel_err(y, r, mag) == 0.0
    assert ref_spmv.rel_err(torch.tensor([1.5, 0.0]), r, mag) == 0.25
    assert ref_spmv.rel_err(torch.tensor([1.0, 1e-9]), r, mag) == \
        float("inf")
    assert ref_spmv.rel_err(torch.ones(3), r, mag) == float("inf")


def test_generators_are_seeded():
    a, b = tiny_csr("rmat", seed=5), tiny_csr("rmat", seed=5)
    c = tiny_csr("rmat", seed=2**31 + 77)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.data, b.data)
    # the structure is the configuration's, the values the run's
    assert np.array_equal(a.indptr, c.indptr)
    assert np.array_equal(a.indices, c.indices)
    assert not np.array_equal(a.data, c.data)
    for m in (a, tiny_csr("powerlaw")):
        rows = np.repeat(np.arange(m.num_rows), m.row_nnz())
        key = rows * m.num_cols + m.indices
        assert (np.diff(key) >= 0).all()
        assert m.data.dtype == np.float32 and m.indices.dtype == np.int32
    rows = np.repeat(np.arange(a.num_rows), a.row_nnz())
    assert (np.diff(rows * a.num_cols + a.indices) > 0).all()
    assert matrices.subseed(-5, "x") != matrices.subseed(5, "x")


@pytest.mark.parametrize("kind,n,nnz", [("powerlaw", 600, 5400),
                                         ("powerlaw", 300, 300 * 120),
                                         ("rmat", 600, 3600),
                                         ("rmat", 256, 256 * 100)])
def test_generators_reach_the_stated_size(kind, n, nnz):
    """Exactly ``nnz`` distinct entries in ``n`` rows, also where the
    degree cap binds (power law) or duplicates are common (dense R-MAT)."""
    spec = dict(kind=kind, num_rows=n, num_cols=n, nnz=nnz,
                structure_seed=7)
    if kind == "powerlaw":
        spec["alpha"] = 1.2
    c = matrices.make(spec, 2**31 + 5, "cpu")
    assert (c.num_rows, c.num_cols, c.nnz) == (n, n, nnz)
    assert len(c.indptr) == n + 1 and c.row_nnz().max() <= n
    rows = np.repeat(np.arange(n), c.row_nnz())
    assert (np.diff(rows * n + c.indices) > 0).all()
    if kind == "powerlaw" and nnz > 100 * n:
        assert c.row_nnz().max() == n       # the cap binds


def test_import_check_compares_whole_top_level_names():
    ok = {"hisparse_tpu_torch", "hisparse_tpu_torch.ops.spmv", "jaxtyping",
          "flaxen.x", "bench_h100.run"}
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok | {"jax.numpy"}) == ["jax"]
    assert harness.forbidden_modules(
        ok | {"hisparse_tpu.ops", "jaxlib", "flax"}) == [
        "flax", "hisparse_tpu", "jaxlib"]


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_h100", "run.py"),
         "--workload", "googleplus-spmv", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_manifest_meets_the_contract():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["bench_h100"]
    assert 1 <= man["run_seconds"] <= 51
    bench = harness.BENCH
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert c["file"] == f"bench_h100/configs/{c['name']}.json"
        assert harness.load_json(os.path.join(ROOT, c["file"]))[
            "source"] == c["source"]
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(bench, "metrics",
                                           f"{m['name']}.py"))
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
        spec = harness.Spec(w["name"], man)
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer
        for m in spec.per_layer:
            moved = [e for e in man["end_to_end"] if e["name"] == m["moves"]]
            assert w["name"] in moved[0].get("workloads", [w["name"]])


@pytest.mark.cuda
def test_tiny_cells_run_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = tiny_bench(tmp_path)
    for w in manifest()["workloads"]:
        spec = harness.Spec(w["name"], manifest(), bench)
        r = harness.run_cell(spec, 9, 0.5, True, "cuda:0")
        assert r["correct"], (w["name"], r["compared"])
        assert r["device"]["busy_s"] > 0


def test_sssp_prepare_is_read_per_layer(tmp_path):
    """``prepare_s`` is end to end only in ``pokec-spmv``; the SSSP cells,
    whose prepare the host's speed spreads too widely for a bound, read it
    per layer as ``prepare_s.sssp``, in traced runs too."""
    bench = tiny_bench(tmp_path)
    traced = run(bench, "pokec-sssp", traced=True)
    assert traced["metrics"]["prepare_s.sssp"]["value"] > 0
    assert "prepare_s" not in run(bench, "pokec-sssp-masked")["metrics"]
    assert run(bench, "pokec-spmv")["metrics"]["prepare_s"]["value"] > 0
