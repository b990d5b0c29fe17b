"""GNN tier: differentiable packed-stream aggregation and a GCN (the port
of ``hisparse_tpu/models/gnn.py``).

* :class:`DiffSpmm`: ``Y = A @ X`` differentiable in X, through a fixed
  pack of A (forward) and of A^T (``dL/dX = A^T @ G``); both directions
  run the SpMM kernel ``wavepack_spmm`` through ``SpmvOperator.matmul``.
  The adjacency values are fixed in the streams when the module is built.
* :class:`GCN`: the Kipf-Welling graph convolution stack
  ``H' = relu(Â H W + b)`` with ``Â = D^-1/2 (A+I) D^-1/2``
  (:func:`gcn_normalize`): aggregation through DiffSpmm, projections
  through ``torch.matmul`` (the JAX package leaves them to XLA).  Per
  layer the order ``Â (H W)`` or ``(Â H) W`` follows ``gcn_apply_fn``, so
  the packed stream feeds the narrower feature width.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix, csr_to_csc
from ..formats.wavepack import pack
from ..ops.autodiff import canonicalize, check_trainable
from ..ops.spmv import SpmvOperator


def gcn_normalize(m: CSRMatrix) -> CSRMatrix:
    """Symmetric GCN normalization ``Â = D^-1/2 (A + I) D^-1/2`` with
    self-loops (Kipf & Welling 2017).  Isolated vertices get a self-loop
    like everyone else, so no row is all-zero."""
    if m.num_rows != m.num_cols:
        raise ValueError("gcn_normalize needs a square adjacency")
    import scipy.sparse as sp
    s = m.to_scipy().astype(np.float64).tocsr()
    s = s + sp.identity(m.num_rows, format="csr")
    d = np.asarray(s.sum(axis=1)).ravel()
    dinv = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)), 0.0)
    s = sp.diags(dinv) @ s @ sp.diags(dinv)
    return CSRMatrix.from_scipy(s.tocsr().astype(np.float32))


def gcn_init_params(dims, seed: int = 0):
    """He-initialized GCN parameters, ``[{'w', 'b'}, ...]`` of float32 CPU
    tensors, drawn from numpy as the JAX package draws them, so one seed
    gives the same parameters in both."""
    rng = np.random.default_rng(seed)
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = (rng.standard_normal((din, dout))
             * np.sqrt(2.0 / din)).astype(np.float32)
        params.append({"w": torch.from_numpy(w),
                       "b": torch.zeros(dout, dtype=torch.float32)})
    return params


def gcn_apply_fn(f, dims):
    """The GCN forward over an aggregation ``f(H) -> Â H``: per layer the
    cheaper of the two identical orders ``Â (H W)`` / ``(Â H) W`` by
    feature width; relu between layers, final layer linear."""
    nl = len(dims) - 1

    def apply(params, X):
        h = X
        for i, p in enumerate(params):
            if dims[i + 1] < dims[i]:       # narrow first: Â (H W)
                h = f(h @ p["w"]) + p["b"]
            else:                            # (Â H) W
                h = f(h) @ p["w"] + p["b"]
            if i < nl - 1:
                h = torch.relu(h)
        return h

    return apply


def spmm_natural(op: SpmvOperator, X: torch.Tensor) -> torch.Tensor:
    """``A @ X -> (num_rows, F)`` in natural row order through ``op``'s
    packed stream.  Kept under the JAX package's name (``_spmm_natural``)
    for code that moves across; the port's operators hold their streams
    as module buffers, so it is ``op.matmul(X)``."""
    return op.matmul(X)


class _SpmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, agg):
        ctx.agg = agg
        return agg.op.matmul(X)

    @staticmethod
    def backward(ctx, G):
        return ctx.agg.opT.matmul(G), None


class DiffSpmm(torch.nn.Module):
    """``Y = A @ X`` (X: (num_cols, F) features) differentiable in X.

    The pattern and values of A are fixed when the module is built (the
    GNN-aggregation regime: Â never trains); ``dL/dX = A^T @ G`` runs
    through a second pack, of A^T.  plus_times fp32 only.  The packs live
    on ``device``; ``col_order`` / ``col_orderT`` and ``pack_kw`` go to
    their ``pack`` calls, and X and G are taken in natural column order
    whatever the column order of the packs."""

    def __init__(self, m: CSRMatrix, config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None, *, device="cuda",
                 split_max="auto", col_order=None, col_orderT=None,
                 **pack_kw):
        super().__init__()
        m = canonicalize(m.astype(np.float32))
        cfg = config or SpmvConfig()
        cfgT = configT or cfg
        check_trainable(cfg, "DiffSpmm")
        check_trainable(cfgT, "DiffSpmm")
        self.m = m
        self.num_rows, self.num_cols = m.num_rows, m.num_cols
        self.wp = pack(m, cfg, split_max=split_max, col_order=col_order,
                       **pack_kw)
        self.op = SpmvOperator(self.wp, device)
        self.wpT = pack(csr_to_csc(m), cfgT, split_max=split_max,
                        col_order=col_orderT, **pack_kw)
        self.opT = SpmvOperator(self.wpT, device)

    def forward(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.op.device)
        return _SpmmFn.apply(X, self)


class GCN(torch.nn.Module):
    """Graph convolutional network over a packed adjacency.

    ``dims = [d_in, d_hidden, ..., d_out]``; layer i computes
    ``H' = relu(Â H W_i + b_i)``, the final layer linear (logits).  ``Â``
    is packed once, in both directions.  The parameters ``w[i]`` and
    ``b[i]`` are ``nn.Parameter``s on ``device``, initialised by
    :func:`gcn_init_params` from ``seed``; :meth:`load_params` sets them
    from a ``[{'w', 'b'}, ...]`` list (see ``interop.gcn_params_from_jax``).
    ``pack_kw`` (``col_order``, ``bm_win``, ...) goes to both packs."""

    def __init__(self, adj: CSRMatrix, dims, config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None, *, device="cuda",
                 normalize: bool = True, split_max="auto", seed: int = 0,
                 col_order=None, **pack_kw):
        super().__init__()
        if len(dims) < 2:
            raise ValueError("dims needs at least [d_in, d_out]")
        a = gcn_normalize(adj) if normalize else adj
        agg = DiffSpmm(a, config, configT, device=device,
                       split_max=split_max, col_order=col_order,
                       col_orderT=col_order, **pack_kw)
        self._init_layers(agg, dims, seed, agg.op.device)

    def _init_layers(self, agg, dims, seed: int, device) -> None:
        """The aggregation ``agg`` and the layers' parameters on
        ``device``, initialised by :func:`gcn_init_params`."""
        self.agg = agg
        self.dims = list(dims)
        self.num_nodes = agg.num_rows
        init = gcn_init_params(self.dims, seed)
        self.w = torch.nn.ParameterList(
            [torch.nn.Parameter(p["w"].to(device)) for p in init])
        self.b = torch.nn.ParameterList(
            [torch.nn.Parameter(p["b"].to(device)) for p in init])
        self._apply_fn = gcn_apply_fn(agg, self.dims)

    def params(self):
        """The parameters as ``[{'w', 'b'}, ...]``."""
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    @torch.no_grad()
    def load_params(self, params) -> None:
        """Copy ``[{'w', 'b'}, ...]`` (tensors or arrays) into the
        parameters, in place."""
        if len(params) != len(self.w):
            raise ValueError(f"{len(params)} layers given, the GCN has "
                             f"{len(self.w)}")
        for p, w, b in zip(params, self.w, self.b):
            w.copy_(torch.as_tensor(p["w"]))
            b.copy_(torch.as_tensor(p["b"]))

    def forward(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.w[0].device)
        return self._apply_fn(self.params(), X)
