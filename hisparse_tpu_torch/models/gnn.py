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
  the packed stream feeds the narrower feature width.  With ``dropout``
  (OGB's full-batch recipe) each hidden layer's relu is followed, in
  training mode, by dropout whose masks come from a ``torch.Generator``
  (:func:`gcn_dropout`), so that a step's masks can be drawn again from the
  generator's state saved before it.
* :func:`is_symmetric`: whether a matrix equals its transpose; a GCN's
  ``Â`` does, and its DiffSpmm then runs both directions through one pack.

Spans (``utils/tracing``): ``hisparse.gcn.layer`` around each layer's
forward, ``hisparse.gcn.agg`` around each forward aggregation,
``hisparse.gcn.agg_grad`` around each backward one (on autograd's thread
for CUDA tensors), ``hisparse.gcn.dropout``.  ``DiffSpmm.launches_fwd`` /
``launches_bwd`` count the SpMM kernel launches each direction has made
(``ops/_kernels.spmm_launches`` across its products; none on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix, csr_to_csc
from ..formats.wavepack import pack
from ..ops import _kernels
from ..ops.autodiff import canonicalize, check_trainable
from ..ops.spmv import SpmvOperator
from ..utils.tracing import span


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


# mirrored values of a symmetric matrix may differ by two float32 ulps:
# gcn_normalize forms Â_ij and Â_ji from the same three float64 factors in
# another order, so their float32 roundings may differ by one
SYMMETRIC_RTOL = 2.0 ** -22


def is_symmetric(m: CSRMatrix, device="cpu") -> bool:
    """Whether ``m`` equals its transpose: the same pattern, and each pair
    of mirrored values equal within ``SYMMETRIC_RTOL`` of the larger.  Two
    sorts of the entries' (row, column) keys on ``device``; an explicit
    zero counts as an entry."""
    if m.num_rows != m.num_cols:
        return False
    dev = torch.device(device)
    n = m.num_rows
    indptr = torch.as_tensor(np.asarray(m.indptr, np.int64), device=dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   indptr[1:] - indptr[:-1])
    cols = torch.as_tensor(np.asarray(m.indices), device=dev).long()
    key, order = torch.sort(rows * n + cols)
    keyT, orderT = torch.sort(cols * n + rows)
    del rows, cols              # GBs at ogbn-products' size
    if not torch.equal(key, keyT):
        return False
    del key, keyT
    vals = torch.as_tensor(np.asarray(m.data), device=dev)
    v, vT = vals[order], vals[orderT]
    return bool(((v - vT).abs()
                 <= SYMMETRIC_RTOL * torch.maximum(v.abs(), vT.abs()))
                .all())


def gcn_dropout(h: torch.Tensor, p: float,
                generator: torch.Generator) -> torch.Tensor:
    """Dropout as OGB's recipe applies it, with masks from ``generator``:
    float32 uniforms ``u`` of ``h``'s shape (``torch.rand`` on ``h``'s
    device), ``h`` kept where ``u >= p`` and scaled by ``1 / (1 - p)``."""
    with span("hisparse.gcn.dropout"):
        u = torch.rand(h.shape, generator=generator, dtype=torch.float32,
                       device=h.device)
        return h * (u >= p) * (1.0 / (1.0 - p))


def gcn_apply_fn(f, dims, dropout: float = 0.0):
    """The GCN forward over an aggregation ``f(H) -> Â H``: per layer the
    cheaper of the two identical orders ``Â (H W)`` / ``(Â H) W`` by
    feature width; relu between layers, final layer linear.  Given a
    ``generator`` and a ``dropout`` above 0, each hidden layer's relu is
    followed by :func:`gcn_dropout`, its masks drawn in layer order."""
    nl = len(dims) - 1

    def apply(params, X, generator=None):
        h = X
        for i, p in enumerate(params):
            with span("hisparse.gcn.layer"):
                if dims[i + 1] < dims[i]:       # narrow first: Â (H W)
                    h = f(h @ p["w"]) + p["b"]
                else:                            # (Â H) W
                    h = f(h) @ p["w"] + p["b"]
                if i < nl - 1:
                    h = torch.relu(h)
                    if generator is not None and dropout > 0:
                        h = gcn_dropout(h, dropout, generator)
        return h

    return apply


def spmm_natural(op: SpmvOperator, X: torch.Tensor) -> torch.Tensor:
    """``A @ X -> (num_rows, F)`` in natural row order through ``op``'s
    packed stream.  Kept under the JAX package's name (``_spmm_natural``)
    for code that moves across; the port's operators hold their streams
    as module buffers, so it is ``op.matmul(X)``."""
    return op.matmul(X)


def _counted(op, X):
    """``op.matmul(X)`` and the SpMM kernel launches it made."""
    n0 = _kernels.spmm_launches
    Y = op.matmul(X)
    return Y, _kernels.spmm_launches - n0


class _SpmmFn(torch.autograd.Function):
    """``Y = A X`` through ``agg.op``; its backward is :class:`_SpmmTFn`."""

    @staticmethod
    def forward(ctx, X, agg):
        ctx.agg = agg
        Y, n = _counted(agg.op, X)
        agg.launches_fwd += n
        return Y

    @staticmethod
    def backward(ctx, G):
        # The product runs as an op of its own inside the span: a profiler
        # puts a kernel down to the innermost op open at its launch, and
        # autograd opens this backward's op before the span starts.
        with span("hisparse.gcn.agg_grad"):
            return _SpmmTFn.apply(G, ctx.agg), None


class _SpmmTFn(torch.autograd.Function):
    """``dL/dX = A^T G`` through ``agg.opT``; its own backward is ``A``."""

    @staticmethod
    def forward(ctx, G, agg):
        ctx.agg = agg
        Y, n = _counted(agg.opT, G)
        agg.launches_bwd += n
        return Y

    @staticmethod
    def backward(ctx, H):
        return _SpmmFn.apply(H, ctx.agg), None


class DiffSpmm(torch.nn.Module):
    """``Y = A @ X`` (X: (num_cols, F) features) differentiable in X.

    The pattern and values of A are fixed when the module is built (the
    GNN-aggregation regime: Â never trains); ``dL/dX = A^T @ G`` runs
    through a second pack, of A^T, or, when A equals A^T
    (:func:`is_symmetric`, checked on ``device``) and ``configT`` and
    ``col_orderT`` are absent or the forward's, through the forward's own
    pack: ``opT is op`` and ``symmetric`` is True.  plus_times fp32
    only.  The packs live on ``device``; ``col_order`` / ``col_orderT``
    and ``pack_kw`` go to their ``pack`` calls, and X and G are taken in
    natural column order whatever the column order of the packs.
    ``launches_fwd`` / ``launches_bwd`` count the SpMM kernel launches
    (``_kernels.spmm_launches``) made through A and through A^T."""

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
        self.symmetric = (cfgT == cfg and col_orderT == col_order
                          and is_symmetric(m, device))
        self.launches_fwd = self.launches_bwd = 0
        self.wp = pack(m, cfg, split_max=split_max, col_order=col_order,
                       **pack_kw)
        self.op = SpmvOperator(self.wp, device)
        if self.symmetric:
            self.wpT, self.opT = self.wp, self.op
        else:
            self.wpT = pack(csr_to_csc(m), cfgT, split_max=split_max,
                            col_order=col_orderT, **pack_kw)
            self.opT = SpmvOperator(self.wpT, device)

    def forward(self, X) -> torch.Tensor:
        with span("hisparse.gcn.agg"):
            X = torch.as_tensor(X, dtype=torch.float32,
                                device=self.op.device)
            return _SpmmFn.apply(X, self)


class GCN(torch.nn.Module):
    """Graph convolutional network over a packed adjacency.

    ``dims = [d_in, d_hidden, ..., d_out]``; layer i computes
    ``H' = relu(Â H W_i + b_i)``, the final layer linear (logits).  ``Â``
    is packed once; a symmetric ``Â`` serves both directions from that
    pack (``DiffSpmm``), any other is packed again as ``Â^T``.  The
    parameters ``w[i]`` and ``b[i]`` are ``nn.Parameter``s on ``device``,
    initialised by :func:`gcn_init_params` from ``seed``;
    :meth:`load_params` sets them from a ``[{'w', 'b'}, ...]`` list (see
    ``interop.gcn_params_from_jax``).
    ``pack_kw`` (``col_order``, ``bm_win``, ...) goes to both packs.
    ``dropout`` > 0 applies :func:`gcn_dropout` after each hidden layer's
    relu in training mode, its masks drawn from the generator passed to
    :meth:`forward` or else from ``self.generator`` (on ``device``,
    seeded from ``seed``)."""

    def __init__(self, adj: CSRMatrix, dims, config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None, *, device="cuda",
                 normalize: bool = True, split_max="auto", seed: int = 0,
                 col_order=None, dropout: float = 0.0, **pack_kw):
        super().__init__()
        if len(dims) < 2:
            raise ValueError("dims needs at least [d_in, d_out]")
        a = gcn_normalize(adj) if normalize else adj
        agg = DiffSpmm(a, config, configT, device=device,
                       split_max=split_max, col_order=col_order,
                       col_orderT=col_order, **pack_kw)
        self._init_layers(agg, dims, seed, agg.op.device, dropout)

    def _init_layers(self, agg, dims, seed: int, device,
                     dropout: float = 0.0) -> None:
        """The aggregation ``agg`` and the layers' parameters on
        ``device``, initialised by :func:`gcn_init_params`."""
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout {dropout} is not in [0, 1)")
        self.agg = agg
        self.dims = list(dims)
        self.num_nodes = agg.num_rows
        self.dropout = dropout
        self.generator = None
        if dropout > 0:
            self.generator = torch.Generator(device=device).manual_seed(seed)
        init = gcn_init_params(self.dims, seed)
        self.w = torch.nn.ParameterList(
            [torch.nn.Parameter(p["w"].to(device)) for p in init])
        self.b = torch.nn.ParameterList(
            [torch.nn.Parameter(p["b"].to(device)) for p in init])
        self._apply_fn = gcn_apply_fn(agg, self.dims, dropout)

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

    def forward(self, X, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """The logits; in training mode with ``dropout`` > 0 the masks
        come from ``generator``, or else from ``self.generator``."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.w[0].device)
        if not (self.training and self.dropout > 0):
            generator = None
        elif generator is None:
            generator = self.generator
        return self._apply_fn(self.params(), X, generator)
