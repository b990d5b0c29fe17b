"""CPU tests that the check decides ``correct`` the right way: every cell
at the tiny size is correct as the program stands, false with its control
in the program's place, and false with each fault its driver can have
planted under the timed path (``faults_<driver>.py``; the look for a card
is skipped; the rest of a run is driven as on the card)."""
from __future__ import annotations

import json
import os

import pytest

from bench_tiny import manifest, run, tiny_bench
from faults import cases, faults_of

from bench_h100 import control, harness
from bench_h100.gen import matrices

CELLS = [w["name"] for w in manifest()["workloads"]]
FAULTS = {(w, name): plant for w, name, plant in cases(manifest())}

# the controls' readings of the four first cells before drivers could give
# their own: the tiny copy, seed 3, requests 0-3
CONTROL_READINGS = {
    "googleplus-spmv": [0.003175837321422874, 0.0032816400241669915] * 2,
    "pokec-sssp": [0.00294267810394155, 0.0025221526902009426,
                   0.003687962123118859, 0.003341907346227617],
    "googleplus-spmm16": [0.003291109402973145, 0.003313392445959597] * 2,
    "pokec-spmv": [0.0037703284109234015, 0.003770286654271842] * 2,
}


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


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_faults_are_caught(bench, workload, fault, monkeypatch):
    FAULTS[workload, fault](monkeypatch)
    r = run(bench, workload)
    assert not r["correct"], (fault, r["compared"])


@pytest.mark.parametrize("workload", sorted(CONTROL_READINGS))
def test_existing_controls_read_as_before(bench, workload):
    """The controls of drivers without their own ``control_spec`` give
    the same numbers, bit for bit, on fixed requests."""
    spec, cell_type = control.control_spec(
        harness.Spec(workload, manifest(), bench))
    csr = matrices.make(spec.config["generator"], 3, "cpu")
    cell = (cell_type or spec.driver().Cell)(spec.config, spec.traffic, csr,
                                             3, "cpu")
    cell.prepare()
    samples = [cell.request(i)[:2] for i in range(4)]
    cell.release()
    assert cell.check(samples) == CONTROL_READINGS[workload]


def test_a_driver_gives_its_own_control(bench, monkeypatch):
    from bench_h100.drivers import calls

    def own(spec):
        return spec, calls.Cell
    monkeypatch.setattr(calls, "control_spec", own, raising=False)
    spec = harness.Spec("googleplus-spmv", manifest(), bench)
    assert control.control_spec(spec) == (spec, calls.Cell)


def test_a_driver_without_faults_is_refused(bench):
    """A cell whose driver has no ``faults_<driver>.py`` fails discovery."""
    with open(os.path.join(bench, "traffic", "queued.json"), "w") as f:
        json.dump({"driver": "queued"}, f)
    man = manifest()
    man["workloads"].append({"name": "googleplus-queued",
                             "config": "googleplus", "traffic": "queued",
                             "chips": 1, "why": "a test"})
    with open(os.path.join(bench, "limits", "googleplus-queued.json"),
              "w") as f:
        json.dump({"max_rel_err": 1e-4}, f)
    with pytest.raises(LookupError, match="queued"):
        cases(man, bench)
    assert [n for n, _ in faults_of("queries")] == [
        "altered", "half", "unchanged"]
