"""The port's sharded trainers (``parallel/train.py``, ``parallel/gnn.py``)
against the JAX package's on the CPU.

The JAX trainers run on four of conftest's 8 CPU devices in interpret
mode, the port's on ``Mesh`` over 4 ``torch.device("cpu")`` entries (the
four shards the card runs), from the same
numbers: the JAX package's stacked values and streams cross through
``interop.sharded_values_from_jax`` (each shard cut to its own nonzeros
or tiles: the JAX stacks are padded to the largest shard, the port's
shards are not), a GCN's parameters through
``interop.gcn_params_from_jax``.  Tolerances:

  * y and dL/dx of ``ShardedDiffSpmv`` / ``ShardedStreamDiffSpmv`` within
    1e-6 of the JAX package's, as max|d| / max(max|ref|, 1): the order of
    fp32 sums in the folds and the dL/dx all-reduce may differ;
  * dL/dvals (``ShardedDiffSpmv``'s gathers, both gradient streams) and
    the SGD-stepped streams bit-equal: one product or one update a slot,
    rounded in the same order;
  * ``ShardedDiffSpmm`` and ``ShardedGCN`` outputs, losses and gradients
    within 1e-5: XLA and torch also sum the dense projections in
    different orders.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.models.gnn import gcn_normalize as ref_gcn_normalize
from hisparse_tpu.parallel import gnn as jgnn
from hisparse_tpu.parallel import train as jtrain
from hisparse_tpu_torch.interop import (gcn_params_from_jax,
                                        sharded_values_from_jax)
from hisparse_tpu_torch.parallel import (Mesh, ShardedDiffSpmm,
                                         ShardedDiffSpmv, ShardedGCN,
                                         ShardedStreamDiffSpmv)

TOL_REF = 1e-6
TOL_GCN = 1e-5
ND = 4                  # shards: four of conftest's eight CPU devices
CFGS = {
    "chain": dict(sublanes=128, bank_blocks=2, stripes=128),
    "bm_steal": dict(sublanes=128, bank_blocks=2, stripes=128,
                     block_major=True, classes_per_group=2,
                     steal_mantissa=True, two_choice=False),
}


@pytest.fixture(autouse=True)
def _one_host_thread(monkeypatch):
    """The JAX package packs shards in a forked process pool when the host
    has cores (``hisparse_tpu/parallel/mesh.py:96-108``); a fork of a
    process that runs torch's and XLA's thread pools can deadlock, so the
    references pack here, one shard after another (the same packs).  The
    plain versions run many small torch ops, whose thread pool stalls when
    the test workers oversubscribe the host's cores: one thread here."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:ND]), ("rows",))


def _port_mesh():
    return Mesh(np.array([torch.device("cpu")] * ND), ("rows",))


def _inputs(m):
    rng = np.random.default_rng(13)
    return (rng.standard_normal(m.num_cols).astype(np.float32),
            rng.standard_normal(m.num_rows).astype(np.float32))


def _padded(g, sd):
    gp = np.zeros(sd.n_devices * sd.rows_per_shard, np.float32)
    gp[:len(g)] = g
    return jnp.asarray(gp.reshape(sd.n_devices, sd.rows_per_shard))


def _tiles(ops):
    return [op.vals.shape[0] for op in ops]


def _cut(sd, theirs, layout):
    """A JAX stream stack (or its gradients) as the port's shards; the
    JAX pad tiles past each shard's own are zero."""
    t = _tiles(sd.d.opsA if layout == "A" else sd.d.opsT)
    a = np.asarray(theirs)
    for d, n in enumerate(t):
        assert not a[d, n:].any()
    return sharded_values_from_jax(theirs, t)


def _backward(module, x, g, **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = module(xt, **kw)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_sharded_diff_matches_jax(kind):
    """``ShardedDiffSpmv`` on the JAX package's stacked values (scaled, so
    they are not the pack's own): y and dL/dx within 1e-6, dL/dvals
    bit-equal, per shard and as the global vector."""
    ref = jtrain.ShardedDiffSpmv(ht.powerlaw_csr(900, 800, 6, seed=11),
                                 _jax_mesh(), ht.SpmvConfig(**CFGS[kind]),
                                 interpret=True)
    sd = ShardedDiffSpmv(hp.powerlaw_csr(900, 800, 6, seed=11), _port_mesh(),
                         hp.SpmvConfig(**CFGS[kind]))
    assert sd.nnz_shard == ref.nnz_shard
    np.testing.assert_array_equal(sd.m.data, ref.m.data)
    v_ref = ref.stack_values(ref.m.data * 1.5)
    vals = sharded_values_from_jax(v_ref, sd.nnz_shard)
    x, g = _inputs(sd.m)
    f, aux = ref.fn()
    y_ref, vjp = jax.vjp(lambda v, xx: f(v, xx, aux), v_ref, jnp.asarray(x))
    gv_ref, gx_ref = vjp(_padded(g, ref))
    vals = [v.requires_grad_(True) for v in vals]
    y, gx = _backward(sd, x, g, vals=vals)
    assert _err(y, np.asarray(y_ref).reshape(-1)[:len(y)]) <= TOL_REF
    assert _err(gx, gx_ref) <= TOL_REF
    for v, r in zip(vals, sharded_values_from_jax(gv_ref, sd.nnz_shard)):
        np.testing.assert_array_equal(v.grad.numpy(), r.numpy())
    np.testing.assert_array_equal(sd.unstack_values([v.grad for v in vals]),
                                  ref.unstack_values(gv_ref))
    np.testing.assert_array_equal(sd.unstack_values(sd.vals), sd.m.data)


@functools.lru_cache(maxsize=None)
def _stream(kind):
    """The JAX stream trainer, its gradients at (x, g) and one SGD step."""
    ref = jtrain.ShardedStreamDiffSpmv(
        ht.powerlaw_csr(900, 800, 6, seed=11), _jax_mesh(),
        ht.SpmvConfig(**CFGS[kind]), interpret=True)
    x, g = _inputs(ref.m)
    f, aux = ref.fn()
    y, vjp = jax.vjp(lambda vA, vT, xx: f(vA, vT, xx, aux), ref.vA0,
                     ref.vT0, jnp.asarray(x))
    grads = vjp(_padded(g, ref))
    stepped = ref.sgd_step(ref.vA0, ref.vT0, grads[0], grads[1], 0.01)
    return (ref, x, g, grads, np.asarray(y).reshape(-1)[:ref.num_rows],
            stepped)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_sharded_stream_matches_jax(kind):
    """``ShardedStreamDiffSpmv``: the shard streams and masks byte-equal to
    the JAX stacks; y and dL/dx within 1e-6; both layouts' gradient
    streams bit-equal, shard by shard, and equal to g[rows]*x[cols]."""
    ref, x, g, (gA_ref, gT_ref, gx_ref), y_ref, _ = _stream(kind)
    sd = ShardedStreamDiffSpmv(hp.powerlaw_csr(900, 800, 6, seed=11),
                               _port_mesh(), hp.SpmvConfig(**CFGS[kind]))
    for mine, theirs, layout in ((sd.vA, ref.vA0, "A"), (sd.vT, ref.vT0, "T"),
                                 (sd.maskA, ref.aux["maskA"], "A"),
                                 (sd.maskT, ref.aux["maskT"], "T")):
        for a, b in zip(mine, _cut(sd, theirs, layout)):
            np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
    y, gx = _backward(sd, x, g)
    assert _err(y, y_ref) <= TOL_REF
    assert _err(gx, gx_ref) <= TOL_REF
    for mine, theirs, layout in ((sd.vA, gA_ref, "A"), (sd.vT, gT_ref, "T")):
        for p, r in zip(mine, _cut(sd, theirs, layout)):
            np.testing.assert_array_equal(p.grad.numpy(), r.numpy())
    m = sd.m
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
    np.testing.assert_array_equal(sd.grads_csr([p.grad for p in sd.vA]),
                                  g[rows] * x[m.indices])
    np.testing.assert_array_equal(sd.grads_csr_T([p.grad for p in sd.vT]),
                                  g[rows] * x[m.indices])


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_sharded_stream_sgd_matches_jax(kind):
    """One SGD step on the JAX package's gradients leaves every shard's
    two streams bit-equal to the JAX step, the layouts bit-consistent;
    from the stepped streams (carried across) y stays within 1e-6 of the
    JAX package's, and a few more steps lower the loss."""
    ref, x, g, (gA_ref, gT_ref, _), _, (vA1, vT1) = _stream(kind)
    sd = ShardedStreamDiffSpmv(hp.powerlaw_csr(900, 800, 6, seed=11),
                               _port_mesh(), hp.SpmvConfig(**CFGS[kind]))
    sd.sgd_step(0.01, _cut(sd, gA_ref, "A"), _cut(sd, gT_ref, "T"))
    for mine, theirs, layout in ((sd.vA, vA1, "A"), (sd.vT, vT1, "T")):
        for a, b in zip(mine, _cut(sd, theirs, layout)):
            np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
    np.testing.assert_array_equal(sd.values(), sd.values_T())
    np.testing.assert_array_equal(sd.values(), ref.values(vA1))
    y = sd(x, vA=_cut(sd, vA1, "A"), vT=_cut(sd, vT1, "T")).detach().numpy()
    assert _err(y, np.asarray(ref(x, vA1))) <= TOL_REF
    y_t = torch.from_numpy(g)

    def loss():
        r = sd(torch.from_numpy(x)) - y_t
        return 0.5 * torch.dot(r, r)

    l0 = float(loss().detach())
    for _ in range(3):
        sd.zero_grad()
        loss().backward()
        sd.sgd_step(0.002)
        np.testing.assert_array_equal(sd.values(), sd.values_T())
    assert float(loss().detach()) < l0


GCN_CFG = dict(sublanes=128, bank_blocks=1, stripes=128)
GCN_DIMS = [8, 4, 3]


@functools.lru_cache(maxsize=None)
def _gcn():
    """The JAX ShardedGCN's parameters, logits, loss and gradients."""
    adj = ht.powerlaw_csr(200, 200, 5.0, seed=3)
    ref = jgnn.ShardedGCN(adj, _jax_mesh(), GCN_DIMS,
                          ht.SpmvConfig(**GCN_CFG), interpret=True)
    params = ref.init(seed=2)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((200, GCN_DIMS[0])).astype(np.float32)
    labels = rng.integers(0, GCN_DIMS[-1], 200)
    f, aux = ref.fn()

    def loss(p):
        logits = f(p, jnp.asarray(X), aux)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(200), labels]), logits

    (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return params, X, labels, np.asarray(logits), float(value), grads


def test_sharded_gcn_matches_jax():
    """``ShardedGCN`` on the JAX model's parameters: logits, the
    cross-entropy and every parameter's gradient within 1e-5; the logits
    also within 1e-5 of the single-device ``GCN`` on the same
    parameters."""
    params, X, labels, logits_ref, loss_ref, grads_ref = _gcn()
    adj = hp.powerlaw_csr(200, 200, 5.0, seed=3)
    gcn = ShardedGCN(adj, _port_mesh(), GCN_DIMS, hp.SpmvConfig(**GCN_CFG))
    gcn.load_params(gcn_params_from_jax(params))
    logits = gcn(torch.from_numpy(X))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels))
    loss.backward()
    assert _err(logits.detach(), logits_ref) <= TOL_GCN
    assert abs(float(loss.detach()) - loss_ref) \
        <= TOL_GCN * max(abs(loss_ref), 1.0)
    for p, w, b in zip(grads_ref, gcn.w, gcn.b):
        assert _err(w.grad, p["w"]) <= TOL_GCN
        assert _err(b.grad, p["b"]) <= TOL_GCN
    one = hp.GCN(adj, GCN_DIMS, hp.SpmvConfig(**GCN_CFG), device="cpu")
    one.load_params(gcn_params_from_jax(params))
    assert _err(logits.detach(), one(torch.from_numpy(X)).detach()) \
        <= TOL_GCN


def test_sharded_diffspmm_matches_jax():
    """``ShardedDiffSpmm`` at F = 5: Y and dL/dX within 1e-5 of the JAX
    package's (its custom vjp through the transpose shards and psum)."""
    ref = jgnn.ShardedDiffSpmm(
        ref_gcn_normalize(ht.powerlaw_csr(260, 260, 5.0, seed=3)),
        _jax_mesh(), ht.SpmvConfig(**CFGS["bm_steal"]), interpret=True)
    agg = ShardedDiffSpmm(hp.gcn_normalize(hp.powerlaw_csr(260, 260, 5.0,
                                                           seed=3)),
                          _port_mesh(), hp.SpmvConfig(**CFGS["bm_steal"]))
    rng = np.random.default_rng(7)
    X = rng.standard_normal((260, 5)).astype(np.float32)
    G = rng.standard_normal((260, 5)).astype(np.float32)
    f, aux = ref.fn()
    Y_ref, vjp = jax.vjp(lambda XX: f(XX, aux), jnp.asarray(X))
    (gX_ref,) = vjp(jnp.asarray(G))
    Xt = torch.from_numpy(X).requires_grad_(True)
    Y = agg(Xt)
    Y.backward(torch.from_numpy(G))
    assert Y.shape == (260, 5)
    assert _err(Y.detach(), Y_ref) <= TOL_GCN
    assert _err(Xt.grad, gX_ref) <= TOL_GCN


def test_sharded_trainers_reject():
    """Only fp32 plus_times packs train (``ValueError``, as
    hisparse_tpu/parallel/train.py:96-100 and gnn.py:67-71 raise); a GCN
    needs two dims."""
    m = hp.uniform_sparse_csr(128, 128, 3, seed=1)
    fixed = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                          dtype="fixed", two_choice=False)
    tropical = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128,
                             semiring="min_plus")
    for cls in (ShardedDiffSpmv, ShardedStreamDiffSpmv, ShardedDiffSpmm):
        for cfg in (fixed, tropical):
            with pytest.raises(ValueError, match="plus_times fp32"):
                cls(m, _port_mesh(), cfg)
        with pytest.raises(ValueError, match="plus_times fp32"):
            cls(m, _port_mesh(), None, tropical)
    with pytest.raises(ValueError, match="dims"):
        ShardedGCN(m, _port_mesh(), [8])
