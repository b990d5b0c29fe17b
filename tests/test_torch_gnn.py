"""The port's GNN tier against the JAX package's on the CPU.

``gcn_normalize``, ``DiffSpmm`` and the ``GCN`` stack go through
``hisparse_tpu.models.gnn`` in interpret mode (as tests/test_gnn.py runs
it) and through the port's modules on CPU tensors, where the SpMM kernel
wrapper runs its plain PyTorch version.  The GCN's parameters are drawn
from one numpy seed in both and carried across with
``interop.gcn_params_from_jax``.  Tolerances, as
max|d| / max(max|ref|, 1):

  * the normalised adjacency bit-equal: the same scipy arithmetic;
  * DiffSpmm forward and dL/dX within 1e-6 of the interpret-mode
    reference: only the order of fp32 sums may differ;
  * GCN logits and parameter gradients within 1e-5: XLA and torch also
    sum the dense projections in different orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.models.gnn import DiffSpmm as RefDiffSpmm
from hisparse_tpu.models.gnn import GCN as RefGCN
from hisparse_tpu.models.gnn import gcn_normalize as ref_gcn_normalize
from hisparse_tpu_torch.interop import gcn_params_from_jax
from hisparse_tpu_torch.models.gnn import gcn_init_params

TOL_REF = 1e-6
TOL_GCN = 1e-5

BM = dict(sublanes=128, bank_blocks=2, stripes=128, block_major=True,
          classes_per_group=2, steal_mantissa=True, two_choice=False)


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def test_gcn_normalize_matches_reference():
    a_r = ref_gcn_normalize(ht.powerlaw_csr(200, 200, 4.0, seed=0))
    a_p = hp.gcn_normalize(hp.powerlaw_csr(200, 200, 4.0, seed=0))
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a_p, f), getattr(a_r, f))
    with pytest.raises(ValueError, match="square"):
        hp.gcn_normalize(hp.powerlaw_csr(20, 30, 2.0, seed=0))


@pytest.mark.parametrize("cfg", [None, BM], ids=["chain-default", "bm-steal"])
def test_diffspmm_matches_reference(cfg):
    ref = RefDiffSpmm(ht.powerlaw_csr(260, 260, 5.0, seed=3),
                      config=cfg and ht.SpmvConfig(**cfg), interpret=True)
    d = hp.DiffSpmm(hp.powerlaw_csr(260, 260, 5.0, seed=3),
                    config=cfg and hp.SpmvConfig(**cfg), device="cpu")
    rng = np.random.default_rng(7)
    X = rng.standard_normal((d.num_cols, 5)).astype(np.float32)
    G = rng.standard_normal((d.num_rows, 5)).astype(np.float32)
    f, aux = ref.fn()
    gx_ref = jax.grad(lambda xx: jnp.vdot(f(xx, aux), jnp.asarray(G)))(
        jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_(True)
    Y = d(Xt)
    Y.backward(torch.from_numpy(G))
    assert Y.shape == (d.num_rows, 5)
    assert _err(Y.detach(), np.asarray(ref(X))) <= TOL_REF
    assert _err(Xt.grad, gx_ref) <= TOL_REF


def test_diffspmm_col_order_matches_dense():
    """Packs with degree column orders take X and G in natural order.
    (The JAX package's DiffSpmm does not permute X for a column-ordered
    pack: ROADMAP.md section C.)"""
    m = hp.powerlaw_csr(260, 260, 5.0, seed=3)
    d = hp.DiffSpmm(m, hp.SpmvConfig(sublanes=128, bank_blocks=1,
                                     stripes=128),
                    device="cpu", col_order="degree", col_orderT="degree")
    assert d.wp.col_order is not None and d.wpT.col_order is not None
    A = d.m.dense().astype(np.float64)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((d.num_cols, 4)).astype(np.float32)
    G = rng.standard_normal((d.num_rows, 4)).astype(np.float32)
    Xt = torch.from_numpy(X).requires_grad_(True)
    Y = d(Xt)
    Y.backward(torch.from_numpy(G))
    assert _err(Y.detach(), A @ X) <= 5e-5
    assert _err(Xt.grad, A.T @ G) <= 5e-5


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits, labels)


def test_gcn_matches_reference_and_trains():
    dims = [16, 8, 4]
    ref = RefGCN(ht.uniform_sparse_csr(256, 256, 6, seed=5), dims,
                 interpret=True)
    params = ref.init(seed=1)
    gcn = hp.GCN(hp.uniform_sparse_csr(256, 256, 6, seed=5), dims,
                 device="cpu", seed=1)
    # one seed, the same draws
    for p_r, p in zip(params, gcn.params()):
        for k in ("w", "b"):
            np.testing.assert_array_equal(p[k].detach().numpy(),
                                          np.asarray(p_r[k]))
    gcn.load_params(gcn_params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in params]))
    rng = np.random.default_rng(9)
    X = rng.standard_normal((256, dims[0])).astype(np.float32)
    labels = rng.integers(0, dims[-1], 256)
    onehot = jnp.asarray(np.eye(dims[-1], dtype=np.float32)[labels])
    apply, aux = ref.fn()

    def ref_loss(p):
        logp = jax.nn.log_softmax(apply(p, jnp.asarray(X), aux))
        return -jnp.mean(jnp.sum(onehot * logp, axis=1))

    out_ref = apply(params, jnp.asarray(X), aux)
    g_ref = jax.grad(ref_loss)(params)
    y = torch.from_numpy(labels)
    out = gcn(torch.from_numpy(X))
    assert _err(out.detach(), out_ref) <= TOL_GCN
    loss = _ce(out, y)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss(params))) <= TOL_GCN
    for i, gr in enumerate(g_ref):
        assert _err(gcn.w[i].grad, gr["w"]) <= TOL_GCN
        assert _err(gcn.b[i].grad, gr["b"]) <= TOL_GCN
    # two SGD steps on the packed model: the loss falls
    l0 = float(loss.detach())
    for _ in range(2):
        with torch.no_grad():
            for p in gcn.parameters():
                p -= 0.5 * p.grad
        gcn.zero_grad()
        loss = _ce(gcn(torch.from_numpy(X)), y)
        loss.backward()
    assert float(loss.detach()) < l0


def test_gcn_rejects_bad_shapes():
    m = hp.uniform_sparse_csr(128, 128, 3, seed=2)
    with pytest.raises(ValueError, match="dims"):
        hp.GCN(m, [8], device="cpu")
    gcn = hp.GCN(m, [8, 4], device="cpu")
    with pytest.raises(ValueError, match="layers"):
        gcn.load_params(gcn_init_params([8, 6, 4]))
