"""The port's tools on the CPU: the reference's benchmark row
(``utils/bench.SpmvMetrics``), the card's HBM rates, ``utils/tracing``,
``utils/hostmem`` with its A/B's verdict, ``utils/parent_ab``'s paired
verdict and its parent-side fold plan, and the parity sweep's family
list.

Every device measurement needs a card and raises without one; whether
there is one is decided inside each test.  ``SpmvMetrics.row()`` and the
phase log are held against the JAX package's under the same fields and
environment.  ``tune_allocator`` changes process-wide settings, and the
JAX package has already called it in this process at import, so its test
runs in a subprocess that imports only the port.
"""
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hisparse_tpu.utils import bench as ht_bench
from hisparse_tpu.utils import tracing as ht_tracing
from hisparse_tpu_torch import SpmvOperator
from hisparse_tpu_torch.utils import (bench, hostmem_ab, parent_ab, parity,
                                      tracing)
from hisparse_tpu_torch.utils.bench import PARITY_FAMILIES, family_case

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("eff", [0.0, 0.4321])
def test_spmv_metrics_row_matches_jax(eff):
    fields = dict(name="googleplus hybrid", preproc_s=3.25, spmv_ms=0.14,
                  gbps=746.7, gops=186.7, stream_gbps=1047.9, fill=0.535,
                  roofline_frac=0.3128, roofline_eff=eff)
    assert (bench.SpmvMetrics(**fields).row()
            == ht_bench.SpmvMetrics(**fields).row())


def test_device_hbm_gbps_by_card_name():
    assert bench.device_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    for name in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(KeyError):
            bench.device_hbm_gbps(name)


def _cpu_operator():
    _, wp, x = family_case(PARITY_FAMILIES[0])
    return SpmvOperator(wp, device="cpu"), torch.from_numpy(x), wp


def _measure():
    op, x, wp = _cpu_operator()
    bench.measure_spmv("chain-fp32", op, x, wp.nnz, wp.stream_bytes)


def _profile():
    with tracing.device_profile("unused", device="cuda"):
        pass


@pytest.mark.parametrize("call", [
    _measure, bench.measured_peak_gbps, bench.device_hbm_gbps, _profile,
    lambda: parity.parity_sweep("cuda")],
    ids=["measure_spmv", "measured_peak_gbps", "device_hbm_gbps",
         "device_profile", "parity_sweep"])
def test_device_tools_raise_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        call()


def test_parity_sweep_refuses_the_cpu():
    with pytest.raises(ValueError, match="no kernel to hold"):
        parity.parity_sweep("cpu")


def test_device_profile_cpu_trace(tmp_path):
    """A CPU trace of the plain SpMV holds its gathers and products."""
    op, x, _ = _cpu_operator()
    with tracing.device_profile(str(tmp_path / "t"), device="cpu") as prof:
        op(x)
    path = pathlib.Path(prof.trace_path)
    assert path.parent == tmp_path / "t" and path.name.endswith(".json")
    events = json.loads(path.read_text())["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::gather", "aten::mul", "aten::sum"} <= ops


def test_device_profile_writes_the_trace_when_the_block_raises(tmp_path):
    """A block that raises still leaves its trace, as the JAX context
    stops its trace in a ``finally``."""
    op, x, _ = _cpu_operator()
    with pytest.raises(ZeroDivisionError):
        with tracing.device_profile(str(tmp_path), device="cpu") as prof:
            op(x)
            1 / 0
    events = json.loads(pathlib.Path(prof.trace_path).read_text())[
        "traceEvents"]
    assert "aten::gather" in {e["name"] for e in events
                              if e.get("cat") == "cpu_op"}


@pytest.mark.parametrize("log", ["0", "1"])
def test_tracing_toggles_follow_jax(log, monkeypatch, capsys):
    monkeypatch.setenv("HISPARSE_LOG", log)
    assert tracing.log_enabled() == ht_tracing.log_enabled()
    out = []
    for mod in (tracing, ht_tracing):
        mod.log_phase("pack googleplus")
        with mod.phase("fold"):
            pass
        err = capsys.readouterr().err
        out.append(re.sub(r"\d\d:\d\d:\d\d|\d+\.\d{3}s", "#", err))
    assert out[0] == out[1]
    assert (out[0] != "") == (log == "1")


def test_tune_allocator_is_idempotent():
    """In a process that imports only the port: the first call tunes
    (numpy's hugepage madvise off), the second returns at once."""
    code = (
        "import sys\n"
        "from hisparse_tpu_torch.utils.hostmem import tune_allocator\n"
        "from numpy._core import multiarray as ma\n"
        "first, second = tune_allocator(), tune_allocator()\n"
        "print(first, second, ma._set_madvise_hugepage(False),\n"
        "      any(k.split('.')[0] in ('jax', 'hisparse_tpu')\n"
        "          for k in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "False", "False"]


@pytest.mark.parametrize("tuned,verdict", [
    ([3.0, 3.1, 2.9, 3.0], "tuned faster"),
    ([3.6, 3.7, 3.5, 3.6], "tuned slower"),
    ([3.1, 3.5, 3.2, 3.6], "unresolved")])
def test_hostmem_ab_verdict(tuned, verdict):
    """The A/B's verdict: the paired differences' mean against twice its
    standard error."""
    untuned = [3.3, 3.4, 3.2, 3.3]
    res = hostmem_ab.compare(untuned, tuned)
    assert res["verdict"] == verdict
    assert res["tuned_won"] == sum(u > t for u, t in zip(untuned, tuned))
    assert res["mean_diff_s"] == pytest.approx(
        np.mean(untuned) - np.mean(tuned))


@pytest.mark.parametrize("change,verdict", [
    ([1.80, 1.85, 1.78, 1.82], "change faster"),
    ([2.40, 2.50, 2.30, 2.45], "change slower"),
    ([1.90, 2.40, 1.95, 2.35], "unresolved")])
def test_parent_ab_verdict(change, verdict):
    """The e2e pairs' verdict: the paired differences (parent - change)
    against twice their standard error."""
    parent = [2.05, 2.10, 2.00, 2.08]
    res = parent_ab.paired(parent, change)
    assert res["verdict"] == verdict
    assert res["change_won"] == sum(p > c for p, c in zip(parent, change))
    assert res["mean_diff_ms"] == pytest.approx(
        np.mean(parent) - np.mean(change))


def test_parent_ab_plan_is_the_checkouts(tmp_path):
    """The parent's fold plan comes from the given checkout's own
    ``fold_plan``, in a fresh process there: this checkout's, here."""
    op = SpmvOperator(family_case(PARITY_FAMILIES[0])[1], device="cpu")
    plan = parent_ab.parent_plan(str(ROOT), op, torch.device("cpu"),
                                 str(tmp_path))
    for got, want in zip(plan, (op.fold_idx, op.fold_ptr, op.fold_long)):
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_parity_families_are_parity_tpu_json():
    rec = json.loads((ROOT / "parity_tpu.json").read_text())
    assert parity.PARITY_FAMILIES_23 == tuple(rec["families"])
    assert len(parity.PARITY_FAMILIES_23) == 23
    assert parity.PARITY_FAMILIES_23[:12] == tuple(
        f[0] for f in PARITY_FAMILIES)


def test_bit_equal_tells_signed_zeros_apart():
    a = torch.tensor([0.0, 1.0, np.inf])
    assert parity.bit_equal(a, a.clone())
    assert not parity.bit_equal(a, torch.tensor([-0.0, 1.0, np.inf]))
    assert parity.rel(a, torch.tensor([0.0, 1.0, -np.inf])) == np.inf
