"""CPU tests that the check decides ``correct`` the right way: every cell
at the tiny size is correct as the program stands, false with its control
in the program's place, and false with each fault the cell can have
planted under the timed path (the look for a card is skipped; the rest of
a run is driven as on the card)."""
from __future__ import annotations

import pytest
import torch

from bench_tiny import manifest, run, tiny_bench

from bench_h100 import control, harness
import hisparse_tpu_torch.ops.spmv as spmv_mod
from hisparse_tpu_torch.models import apps
from hisparse_tpu_torch.ops.spmv import IDENTITY, SpmvOperator

CELLS = [w["name"] for w in manifest()["workloads"]]
CALL_CELLS = [w["name"] for w in manifest()["workloads"]
              if w["traffic"] != "sssp"]
QUERY_CELLS = [w["name"] for w in manifest()["workloads"]
               if w["traffic"] == "sssp"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


def limit_of(workload):
    return harness.load_json(f"{harness.BENCH}/limits/{workload}.json")[
        "max_rel_err"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_and_its_control_is_not(bench, workload):
    r = run(bench, workload)
    assert r["correct"], r["compared"]
    assert r["compared"]["max_rel_err"]["limit"] == limit_of(workload)
    spec, cell_type = control.control_spec(
        harness.Spec(workload, manifest(), bench))
    c = harness.run_cell(spec, 3, 0.2, False, "cpu", cell_type=cell_type)
    assert not c["correct"], c["compared"]
    assert c["compared"]["max_rel_err"]["value"] > limit_of(workload)


def _half_the_slots(fn, semiring_of):
    """The kernel with half of every tile's slots left out: they hold the
    semiring's identity, as if never streamed."""
    def broken(vals, idxT, *args, **kw):
        cfg = next(a for a in args if hasattr(a, "semiring"))
        v = vals.clone()
        flat = v.view(v.shape[0], -1)
        flat[:, ::2] = (0 if v.dtype != torch.float32
                        else IDENTITY[semiring_of(cfg)])
        return fn(v, idxT, *args, **kw)
    return broken


@pytest.mark.parametrize("workload", CALL_CELLS)
@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_call_faults_are_caught(bench, workload, fault, monkeypatch):
    if fault == "altered":
        for name in ("forward", "matmul"):
            orig = getattr(SpmvOperator, name)

            def altered(self, *a, _orig=orig, **kw):
                y = _orig(self, *a, **kw).clone()
                y.view(-1)[y.numel() // 2] += 1.0
                return y
            monkeypatch.setattr(SpmvOperator, name, altered)
    elif fault == "half":
        for name in ("wavepack_spmv", "wavepack_spmm"):
            monkeypatch.setattr(spmv_mod, name, _half_the_slots(
                getattr(spmv_mod, name), lambda cfg: cfg.semiring))
    else:
        for name in ("forward", "matmul"):
            orig = getattr(SpmvOperator, name)
            last = {}

            def stale(self, *a, _orig=orig, _last=last, **kw):
                y = _orig(self, *a, **kw)
                prev = _last.get("y", y)
                _last["y"] = y
                return prev
            monkeypatch.setattr(SpmvOperator, name, stale)
    r = run(bench, workload)
    assert not r["correct"], (fault, r["compared"])


@pytest.mark.parametrize("workload", QUERY_CELLS)
@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_query_faults_are_caught(bench, workload, fault, monkeypatch):
    if fault == "altered":
        orig = apps.SSSP.run

        def altered(self, *a, **kw):
            d = orig(self, *a, **kw).clone()
            reached = torch.nonzero(torch.isfinite(d) & (d > 0)).flatten()
            d[reached[len(reached) // 2]] *= 1.01
            return d
        monkeypatch.setattr(apps.SSSP, "run", altered)
    elif fault == "half":
        monkeypatch.setattr(spmv_mod, "wavepack_spmv", _half_the_slots(
            spmv_mod.wavepack_spmv, lambda cfg: cfg.semiring))
    else:
        monkeypatch.setattr(apps.SSSP, "step",
                            lambda self, x: (x, torch.tensor(False)))
    r = run(bench, workload)
    assert not r["correct"], (fault, r["compared"])
