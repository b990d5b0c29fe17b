"""The port's spans (``utils/tracing.span``) in the operator's call path, the
apps' loop and the pack: off unless a profiler runs (no
``record_function`` entered), and under a CPU ``torch.profiler`` the span
tree the benchmark's readers climb: ``hisparse.forward`` / ``matmul`` /
``masked`` around a call with its ``hisparse.x`` and
``hisparse.stripe_fold``, one ``hisparse.step`` an app iteration with its
``hisparse.sync`` and ``hisparse.combine``, the pack's phases; and the
span's HISPARSE_LOG lines."""
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import hisparse_tpu_torch as hp
from hisparse_tpu_torch.models import apps
from hisparse_tpu_torch.ops.spmv import SPMM_MAX_F
from hisparse_tpu_torch.utils import tracing

CFG = dict(sublanes=128, bank_blocks=1, stripes=128)
# the most spans one operator call may open, its own included
MAX_SPANS_A_CALL = 5


def _matrix(n=700, density=0.01, seed=3):
    m = sp.random(n, n, density=density, random_state=seed, format="csr",
                  dtype=np.float32)
    return hp.CSRMatrix.from_scipy(m)


@pytest.fixture(scope="module")
def op():
    return hp.SpmvOperator(hp.pack(_matrix(), hp.SpmvConfig(**CFG),
                                   col_order="degree"), device="cpu")


@pytest.fixture(scope="module")
def sssp():
    rng = np.random.default_rng(5)
    n = 300
    mask = rng.random((n, n)) < 0.03
    np.fill_diagonal(mask, False)
    dense = np.where(mask, rng.random((n, n)) + 0.1, 0.0).astype(np.float32)
    return apps.SSSP(hp.CSRMatrix.from_scipy(sp.csr_matrix(dense)),
                     hp.SpmvConfig(**CFG), device="cpu")


def _calls(op, sssp):
    x = torch.rand(op.wp.num_cols)
    X = torch.rand(op.wp.num_cols, 20)
    return {"forward": lambda: op(x),
            "matmul": lambda: op.matmul(X),
            "masked": lambda: op.masked(x, np.arange(0, op.wp.num_cols, 7)),
            "sssp": lambda: sssp.run(0)}


class _Node:
    def __init__(self, name):
        self.name, self.children = name, []

    def names(self):
        return [c.name for c in self.children]

    def count(self):
        return 1 + sum(c.count() for c in self.children)


def _span_forest(prof):
    """The ``hisparse.*`` host events as a forest: each span's parent is
    its nearest enclosing ``hisparse.*`` span (torch ops between them are
    skipped), children in time order."""
    nodes, roots = {}, []
    events = sorted((e for e in prof.events()
                     if e.name.startswith("hisparse.")),
                    key=lambda e: e.time_range.start)
    for e in events:
        nodes[id(e)] = _Node(e.name)
    for e in events:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("hisparse."):
            p = p.cpu_parent
        (nodes[id(p)].children if p is not None else roots).append(
            nodes[id(e)])
    return roots


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _span_forest(prof)


@pytest.mark.parametrize("call", ["forward", "matmul", "masked", "sssp"])
def test_no_record_function_without_a_profiler(op, sssp, call,
                                                 monkeypatch):
    entered = []

    class Counting(autograd_profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    monkeypatch.delenv("HISPARSE_LOG", raising=False)
    _calls(op, sssp)[call]()
    assert entered == []
    # and the null path is one shared object
    assert tracing.span("hisparse.x") is tracing.span("hisparse.forward")


def test_forward_span_tree(op):
    _, roots = _profiled(_calls(op, None)["forward"])
    assert [r.name for r in roots] == ["hisparse.forward"]
    assert roots[0].names() == ["hisparse.x", "hisparse.stripe_fold"]
    assert roots[0].count() <= MAX_SPANS_A_CALL


def test_matmul_span_tree_folds_each_chunk(op):
    """F = SPMM_MAX_F + 4 streams in two chunks (SPMM_MAX_F + 4): an x span
    and a stripe fold each, the first x span also holding the column
    gather."""
    X = torch.rand(op.wp.num_cols, SPMM_MAX_F + 4)
    _, roots = _profiled(lambda: op.matmul(X))
    assert [r.name for r in roots] == ["hisparse.matmul"]
    assert roots[0].names() == ["hisparse.x", "hisparse.stripe_fold"] * 2
    assert roots[0].count() <= MAX_SPANS_A_CALL


def test_masked_span_tree(op):
    _, roots = _profiled(_calls(op, None)["masked"])
    assert [r.name for r in roots] == ["hisparse.masked"]
    assert roots[0].names() == ["hisparse.x", "hisparse.x",
                                "hisparse.stripe_fold"]
    assert roots[0].count() <= MAX_SPANS_A_CALL


@pytest.mark.parametrize("masked", [False, True])
def test_sssp_one_step_span_an_iteration(sssp, masked):
    """``iters_run`` step spans (the dense run's last one ends at the
    ``break``), each with one host read and one fold into rank order
    (``hisparse.combine``, which holds no operator call); the operator
    call inside keeps its own tree."""
    d, roots = _profiled(lambda: sssp.run(0, masked=masked))
    dense = sssp.run(0)
    np.testing.assert_array_equal(d.numpy(), dense.numpy())
    # the masked run's last iteration finds an empty frontier: a read and
    # no product
    n_steps = sssp.iters_run + (1 if masked else 0)
    assert [r.name for r in roots] == ["hisparse.step"] * n_steps
    for i, step in enumerate(roots):
        names = step.names()
        last_empty = masked and i == n_steps - 1
        assert names.count("hisparse.sync") == 1
        assert names.count("hisparse.combine") == (0 if last_empty else 1)
        if not last_empty:
            call = "hisparse.forward" if not masked else "hisparse.x"
            assert call in names
        for c in step.children:
            if c.name == "hisparse.combine":
                # the fold into rank order: one kernel, no operator call
                assert not c.children


@pytest.mark.parametrize("app", ["pagerank", "bfs"])
def test_other_apps_one_step_span_an_iteration(app):
    m = _matrix(300, 0.03, seed=7)
    if app == "pagerank":
        a = apps.PageRank(m, hp.SpmvConfig(**CFG), device="cpu")
        _, roots = _profiled(lambda: a.run(4))
        assert [r.name for r in roots] == ["hisparse.step"] * 4
        # PageRank reads nothing back
        assert all("hisparse.sync" not in r.names() for r in roots)
    else:
        a = apps.BFS(m, hp.SpmvConfig(**CFG), device="cpu")
        level, roots = _profiled(lambda: a.run(0))
        assert roots and {r.name for r in roots} == {"hisparse.step"}
        assert all(r.names().count("hisparse.sync") == 1 for r in roots)
        assert len(roots) == int(level.max()) + 1
    assert all(r.names().count("hisparse.combine") == 1 for r in roots)


def test_pack_phases_are_spans():
    m = _matrix()
    _, roots = _profiled(lambda: hp.pack(m, hp.SpmvConfig(**CFG)))
    assert [r.name for r in roots] == ["hisparse.pack.split",
                                       "hisparse.pack.rename",
                                       "hisparse.pack.plan_emit"]
    inner = roots[2].names()
    assert inner in ([], ["hisparse.pack.native_plan",
                          "hisparse.pack.native_alloc",
                          "hisparse.pack.native_emit"])


@pytest.mark.parametrize("profiled", [False, True])
def test_span_logs_like_phase(profiled, monkeypatch, capsys):
    """Under HISPARSE_LOG=1 a span logs its entry and its duration, with a
    profiler running or not; under a profiler it is also recorded."""
    monkeypatch.setenv("HISPARSE_LOG", "1")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("hisparse.fold"):
                torch.ones(3).sum()
        assert "hisparse.fold" in {e.name for e in prof.events()}
    else:
        with tracing.span("hisparse.fold"):
            pass
    err = re.sub(r"\d\d:\d\d:\d\d|\d+\.\d{3}s", "#", capsys.readouterr().err)
    assert err == ("[INFO #] hisparse.fold ...\n"
                   "[INFO #] hisparse.fold done in #\n")
    monkeypatch.setenv("HISPARSE_LOG", "0")
    with tracing.span("hisparse.fold"):
        pass
    assert capsys.readouterr().err == ""
