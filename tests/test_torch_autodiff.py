"""The port's DiffSpmv against the JAX package's on the CPU.

The same matrix and the same numpy-seeded x and cotangent g go through
``hisparse_tpu.ops.autodiff.DiffSpmv`` in interpret mode (as
tests/test_autodiff.py runs it) and through the port's
``DiffSpmv(device="cpu")``, whose kernel wrapper runs the plain PyTorch
version on CPU tensors.  Tolerances, as max|d| / max(max|ref|, 1):

  * y and x_bar within 1e-6 of the interpret-mode reference: both decode
    the stream the same way, so only the order of fp32 sums may differ
    (hub-split recombine, stripe fold);
  * v_bar = g[rows] * x[cols] bit-equal: one product per nonzero;
  * against the scipy oracle, the JAX test's own bounds: 5e-5, or 5e-4
    with steal_mantissa (its 2^-17 value truncation).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.autodiff import DiffSpmv as RefDiffSpmv

TOL_REF = 1e-6


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _port_grads(d, x, g):
    """(y, v_bar, x_bar) of the port module for cotangent g."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = d(xt)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), d.vals.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("steal", [False, True], ids=["plain", "steal"])
def test_diffspmv_matches_reference(steal):
    m_r = ht.powerlaw_csr(260, 301, 5.0, seed=3)
    m_p = hp.powerlaw_csr(260, 301, 5.0, seed=3)
    ref = RefDiffSpmv(m_r, ht.SpmvConfig(steal_mantissa=steal),
                      interpret=True)
    d = hp.DiffSpmv(m_p, hp.SpmvConfig(steal_mantissa=steal), device="cpu")
    np.testing.assert_array_equal(d.vals.detach().numpy(),
                                  np.asarray(ref.v0))
    rng = np.random.default_rng(7)
    x = rng.standard_normal(d.num_cols).astype(np.float32)
    g = rng.standard_normal(d.num_rows).astype(np.float32)
    f, aux = ref.fn()
    y_ref = np.asarray(ref(x))
    gv_ref, gx_ref = jax.grad(
        lambda v, xx: jnp.vdot(f(v, xx, aux), jnp.asarray(g)),
        argnums=(0, 1))(ref.v0, jnp.asarray(x))
    y, gv, gx = _port_grads(d, x, g)
    assert y.shape == (d.num_rows,) and np.isfinite(y).all()
    assert _err(y, y_ref) <= TOL_REF
    assert _err(gx, gx_ref) <= TOL_REF
    np.testing.assert_array_equal(gv, np.asarray(gv_ref))
    # and against the scipy oracle
    A = d.m.to_scipy()
    tol = 5e-4 if steal else 5e-5
    assert _err(y, A @ x) <= tol and _err(gx, A.T @ g) <= tol


def test_value_update_re_emits_stream():
    """The optimizer-step pattern: same pack, new values each call (the
    ``vals`` argument or an in-place update of the parameter)."""
    m = hp.uniform_sparse_csr(190, 210, 4, seed=5)
    d = hp.DiffSpmv(m, hp.SpmvConfig(), device="cpu")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(m.num_cols).astype(np.float32))
    v1 = rng.standard_normal(d.vals.shape[0]).astype(np.float32)
    s = d.m.to_scipy().copy()
    s.data[:] = v1
    y1 = d(x, vals=torch.from_numpy(v1)).detach().numpy()
    assert np.abs(y1 - s @ x.numpy()).max() <= 1e-4
    y_t = torch.from_numpy(rng.standard_normal(m.num_rows).astype(np.float32))

    def loss():
        r = d(x) - y_t
        return 0.5 * torch.dot(r, r)

    l0 = loss()
    l0.backward()
    with torch.no_grad():
        d.vals -= 0.05 * d.vals.grad
    assert float(loss().detach()) < float(l0.detach())


def test_rejects_nondiff_configs():
    m = hp.uniform_sparse_csr(64, 64, 3, seed=1)
    with pytest.raises(ValueError):
        hp.DiffSpmv(m, hp.SpmvConfig(dtype="fixed"), device="cpu")
    with pytest.raises(ValueError):
        hp.DiffSpmv(m, hp.SpmvConfig(semiring="min_plus"), device="cpu")


def test_canonicalization_dedups_and_drops_zeros():
    import scipy.sparse as sp
    rows = np.array([0, 0, 1, 2, 2])
    cols = np.array([1, 1, 0, 2, 3])
    vals = np.array([1.0, 2.0, 0.0, 3.0, 4.0], np.float32)
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(4, 4))
    d = hp.DiffSpmv(hp.CSRMatrix.from_scipy(coo.tocsr()), hp.SpmvConfig(),
                    device="cpu")
    # duplicates summed, explicit zero dropped -> 3 trainable values
    assert d.vals.shape == (3,)
    x = np.arange(4, dtype=np.float32)
    y = d(torch.from_numpy(x)).detach().numpy()
    assert np.abs(y - coo.tocsr() @ x).max() <= 1e-6


def test_col_orders_take_natural_order():
    """Packs with degree column orders: x and the cotangent stay in
    natural order, and the result matches the unordered module."""
    m = hp.powerlaw_csr(300, 420, 6.0, seed=21)
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=128)
    d0 = hp.DiffSpmv(m, cfg, device="cpu")
    d1 = hp.DiffSpmv(m, cfg, device="cpu", col_order="degree",
                     col_orderT="degree")
    assert d1.wp.col_order is not None and d1.wpT.col_order is not None
    rng = np.random.default_rng(22)
    x = rng.standard_normal(m.num_cols).astype(np.float32)
    g = rng.standard_normal(m.num_rows).astype(np.float32)
    for a, b in zip(_port_grads(d1, x, g), _port_grads(d0, x, g)):
        assert _err(a, b) <= TOL_REF
