"""The port's GCN training step against the plain reference
(``hisparse_tpu_torch/reference/gcn.py``) on the CPU, at a tiny size on
seeded random weights: OGB's full-batch recipe (relu then dropout after
each hidden layer, ``log_softmax`` + ``nll_loss`` over training nodes,
Adam) through ``GCN``, ``DiffSpmm`` and ``SpmvOperator.matmul``, whose
kernel wrapper runs its plain version on CPU tensors.

Tolerances, normwise ``|a - b| / |b|`` against the reference in float64:

  * the dropout masks bit-equal: the same float32 uniforms of one
    generator state, compared with the same ``>=``;
  * loss 1e-6 and each gradient 1e-5: float32 sums (an aggregation over a
    row's few dozen entries, a projection over up to 256 features, a
    weight gradient over 300 nodes) each round at about 2^-24 a term, and
    a relu whose input rounds across 0 moves a gradient entry a little;
  * the Adam update 1e-5, on the program's own gradients and state: one
    float32 rounding of each moment, and of ``p`` after the step, against
    an update of about ``lr``;
  * ``matmul`` at F = 20 and 47 within 1e-6 of the float64 product, as
    ``tests/test_torch_spmm.py`` holds it.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import hisparse_tpu_torch as hp
from hisparse_tpu_torch.models import gnn
from hisparse_tpu_torch.ops import _kernels, spmv
from hisparse_tpu_torch.reference import gcn as ref

N = 300
DIMS = [20, 40, 40, 7]
P = 0.5
LR = 0.01
CFG = dict(sublanes=128, bank_blocks=1, stripes=128)
TOL_LOSS = 1e-6
TOL_GRAD = 1e-5
TOL_ADAM = 1e-5
TOL_SPMM = 1e-6


def _adjacency(symmetric: bool, seed: int = 4) -> hp.CSRMatrix:
    """A unit-valued graph on N nodes without self-loops: undirected
    (both directions of each edge) or directed."""
    a = sp.random(N, N, density=0.03, random_state=seed, format="csr")
    if symmetric:
        a = a + a.T
    a.setdiag(0)
    a.eliminate_zeros()
    a.data[:] = 1.0
    return hp.CSRMatrix.from_scipy(a.astype(np.float32).tocsr())


def _gcn(adj, dropout=P, seed=1):
    return hp.GCN(adj, DIMS, hp.SpmvConfig(**CFG), device="cpu", seed=seed,
                  dropout=dropout, col_order="degree")


def _data(seed=2):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(N, DIMS[0], generator=g)
    labels = torch.randint(0, DIMS[-1], (N,), generator=g)
    train = torch.sort(torch.randperm(N, generator=g)[:N // 3]).values
    return X, labels, train


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def _step(gcn, X, labels, train, generator):
    logits = gcn(X, generator=generator)
    loss = torch.nn.functional.nll_loss(
        torch.log_softmax(logits, dim=-1)[train], labels[train])
    loss.backward()
    return loss


def _reference(adj, gcn, X, labels, train, state):
    a = ref.Adjacency(N, adj.indptr, adj.indices, adj.data, "cpu")
    g = torch.Generator()
    g.set_state(state)
    return ref.loss_and_grads(a, gcn.params(), X, labels, train, P, g)


@pytest.fixture(scope="module")
def sym():
    return _adjacency(True)


def test_dropout_masks_equal_the_reference():
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    h = torch.ones(N, 40)
    ours = gnn.gcn_dropout(h, P, g)
    g2 = torch.Generator()
    g2.set_state(state)
    theirs = ref.dropout(h.double(), P, g2)
    assert torch.equal(ours.double(), theirs)
    kept = float((ours > 0).double().mean())
    assert 0.4 < kept < 0.6 and set(ours.unique().tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
def test_loss_and_gradients_match_the_reference(symmetric, sym):
    adj = sym if symmetric else _adjacency(False)
    gcn = _gcn(adj)
    # one pack for a symmetric Â, a second for Â^T otherwise
    assert (gcn.agg.opT is gcn.agg.op) == symmetric
    assert gcn.agg.symmetric == symmetric
    X, labels, train = _data()
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    loss = _step(gcn, X, labels, train, g)
    loss_ref, grads_ref = _reference(adj, gcn, X, labels, train, state)
    assert _rel(loss, loss_ref) <= TOL_LOSS
    for i, gr in enumerate(grads_ref):
        assert _rel(gcn.w[i].grad, gr["w"]) <= TOL_GRAD, i
        assert _rel(gcn.b[i].grad, gr["b"]) <= TOL_GRAD, i
    # the masks matter: without them the loss is another one
    loss_plain, _ = ref.loss_and_grads(
        ref.Adjacency(N, adj.indptr, adj.indices, adj.data, "cpu"),
        gcn.params(), X, labels, train)
    assert _rel(loss, loss_plain) > 100 * TOL_LOSS


def test_adam_step_matches_the_reference(sym):
    gcn = _gcn(sym)
    X, labels, train = _data()
    opt = torch.optim.Adam(gcn.parameters(), lr=LR)
    g = torch.Generator().manual_seed(5)
    for step in range(3):
        before = [p.detach().clone() for p in gcn.parameters()]
        state = [(opt.state[p]["exp_avg"].clone(),
                  opt.state[p]["exp_avg_sq"].clone())
                 if opt.state[p] else (torch.zeros_like(p),) * 2
                 for p in gcn.parameters()]
        opt.zero_grad()
        _step(gcn, X, labels, train, g)
        opt.step()
        for p, p0, (m, v) in zip(gcn.parameters(), before, state):
            new, _, _ = ref.adam(p0.double(), p.grad.double(), m.double(),
                                 v.double(), step, LR)
            assert _rel(p - p0, new - p0.double()) <= TOL_ADAM, step


def test_symmetric_check(sym):
    assert gnn.is_symmetric(sym)
    assert gnn.is_symmetric(hp.gcn_normalize(sym))
    assert not gnn.is_symmetric(_adjacency(False))
    s = sym.to_scipy().tolil()
    i, j = sym.indices[0], 0
    s[i, j] = 3.0                       # one mirrored value changed
    assert not gnn.is_symmetric(hp.CSRMatrix.from_scipy(s.tocsr()))
    # a transpose packed otherwise takes a pack of its own
    d = hp.DiffSpmm(sym, hp.SpmvConfig(**CFG), device="cpu",
                    col_order="degree", col_orderT="degree")
    assert d.symmetric and d.opT is d.op
    d = hp.DiffSpmm(sym, hp.SpmvConfig(**CFG), device="cpu",
                    col_order="degree")
    assert not d.symmetric and d.opT is not d.op


@pytest.mark.parametrize("F", [20, 47])
def test_matmul_wide_features(F, sym):
    """F = 20 and 47 take 16-feature chunks and tails of 4 and 15."""
    a = hp.gcn_normalize(sym)
    op = hp.SpmvOperator(hp.pack(a, hp.SpmvConfig(**CFG), split_max="auto",
                                 col_order="degree"), device="cpu")
    X = torch.randn(N, F, generator=torch.Generator().manual_seed(F))
    want = torch.from_numpy(a.to_scipy().astype(np.float64) @ X.double()
                            .numpy())
    got = op.matmul(X)
    assert got.shape == (N, F)
    assert float((got.double() - want).abs().max()
                 / max(float(want.abs().max()), 1.0)) <= TOL_SPMM


def _spans(prof):
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.name.startswith("hisparse.gcn.")]


def _count_plain_calls(monkeypatch):
    """Each call of the CPU's plain SpMM counted as the card counts a
    launch of the SpMM kernel (``_kernels.spmm_launches``)."""
    monkeypatch.setattr(_kernels, "spmm_launches", _kernels.spmm_launches)
    plain = spmv.spmm_tiles_plain

    def counted(*args, **kw):
        _kernels.spmm_launches += 1
        return plain(*args, **kw)
    monkeypatch.setattr(spmv, "spmm_tiles_plain", counted)


def test_spans_and_launch_counters(sym, monkeypatch):
    gcn = _gcn(sym)
    X, labels, train = _data()
    # no kernel runs on the CPU, so none is counted
    _step(gcn, X, labels, train, torch.Generator().manual_seed(5))
    assert (gcn.agg.launches_fwd, gcn.agg.launches_bwd) == (0, 0)
    gcn.zero_grad()
    _count_plain_calls(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(gcn, X, labels, train, torch.Generator().manual_seed(5))
    names = _spans(prof)
    assert names.count("hisparse.gcn.layer") == 3
    assert names.count("hisparse.gcn.agg") == 3
    assert names.count("hisparse.gcn.dropout") == 2
    # X takes no gradient: layer 1, (Â X) W, has no backward aggregation
    assert names.count("hisparse.gcn.agg_grad") == 2
    assert names.index("hisparse.gcn.agg_grad") > max(
        i for i, n in enumerate(names) if n == "hisparse.gcn.layer")
    # each aggregation's matmul runs inside its span
    evs = {e.name: e for e in prof.events()}
    grad = [e for e in prof.events() if e.name == "hisparse.gcn.agg_grad"]
    for e in grad:
        def inner(name):
            return [c for c in prof.events() if c.name == name
                    and e.time_range.start <= c.time_range.start
                    and c.time_range.end <= e.time_range.end]
        assert len(inner("hisparse.matmul")) == 1
        # the product is an op that opens inside the span, so that a CUDA
        # trace puts its kernels down to the span (bench_h100/spans.py)
        assert len(inner("_SpmmTFn")) == 1
    assert "hisparse.gcn.agg" in evs
    # a launch a chunk of up to SPMM_MAX_F features: forward at F = 20,
    # 40, 7, backward at 40, 7
    def launches(widths):
        return sum(-(-f // spmv.SPMM_MAX_F) for f in widths)
    assert (gcn.agg.launches_fwd, gcn.agg.launches_bwd) == (
        launches([20, 40, 7]), launches([40, 7]))


def test_double_backward_runs_through_both_packs(sym, monkeypatch):
    """The backward is differentiable: d/dG of <A^T G, V> is A V."""
    _count_plain_calls(monkeypatch)
    agg = _gcn(sym).agg
    X = torch.randn(N, 5, requires_grad=True)
    G = torch.randn(N, 5, requires_grad=True)
    V = torch.randn(N, 5)
    (gx,) = torch.autograd.grad(agg(X), X, G, create_graph=True)
    (gg,) = torch.autograd.grad((gx * V).sum(), G)
    assert torch.allclose(gg, agg(V), rtol=0, atol=1e-6)
    assert (agg.launches_fwd, agg.launches_bwd) == (3, 1)


def test_no_dropout_is_the_old_forward(sym):
    """``dropout=0.0`` (and eval mode with dropout) is bit for bit the
    forward without dropout: ``gcn_apply_fn`` as it was."""
    X, _, _ = _data()
    gcn = _gcn(sym, dropout=0.0)
    assert gcn.generator is None

    def old(params):
        h = X
        for i, p in enumerate(params):
            if DIMS[i + 1] < DIMS[i]:
                h = gcn.agg(h @ p["w"]) + p["b"]
            else:
                h = gcn.agg(h) @ p["w"] + p["b"]
            if i < len(DIMS) - 2:
                h = torch.relu(h)
        return h

    want = old(gcn.params())
    assert torch.equal(gcn(X), want)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(gcn(X, generator=g), want)
    dropped = _gcn(sym)
    dropped.eval()
    assert torch.equal(dropped(X), want)
    dropped.train()
    assert not torch.equal(dropped(X), want)
    with pytest.raises(ValueError, match="dropout"):
        _gcn(sym, dropout=1.0)
