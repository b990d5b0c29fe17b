"""Distributed GNN training, row-sharded aggregation over the mesh: the
port of ``hisparse_tpu/parallel/gnn.py``.

:class:`ShardedDiffSpmm` is the mesh form of :class:`~..models.gnn.
DiffSpmm`: the normalized adjacency is row-sharded like
:class:`~.mesh.ShardedSpmv`, the features are copied to every shard
(full-batch GCN's mesh layout):

  * forward ``Y = Â H``: shard d runs the SpMM kernel on its pack of Â_d
    against the features (one pass of the stream feeds up to 16 columns),
    folds to its natural rows, and one :func:`~.mesh.all_gather` brings
    the aggregated rows together for the next layer's projection;
  * cotangent ``dL/dH = Â^T G``: shard d runs its transpose pack on its
    own rows of G, and the full-length partials sum in one
    :func:`~.mesh.all_reduce`;
  * the adjacency is fixed in the streams when the module is built: no
    value plumbing, unlike :class:`~.train.ShardedDiffSpmv`.

:class:`ShardedGCN` is :class:`~..models.gnn.GCN` over that aggregation:
the same parameters and forward, so a single-device model's parameters
(or a JAX model's, through ``interop.gcn_params_from_jax``) load
unchanged.  The JAX package's chunking of F under the TPU's VMEM budget
has no counterpart: ``SpmvOperator.matmul`` takes up to 16 features a
launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix, csr_to_csc
from ..models.gnn import GCN, gcn_normalize
from ..ops.autodiff import canonicalize, check_trainable
from ..ops.spmv import SpmvOperator
from .mesh import Mesh, _pack_shards, all_reduce
from .train import _row_shards, gather_rows, split_rows_to


class _ShardedSpmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, agg):
        ctx.agg = agg
        parts = [op.matmul(X.to(op.device)) for op in agg.opsA]
        return gather_rows(parts, agg.num_rows, X.device)

    @staticmethod
    def backward(ctx, G):
        agg = ctx.agg
        gs = split_rows_to(G, agg.rows_per_shard, agg.devices)
        parts = [op.matmul(g_d) for op, g_d in zip(agg.opsT, gs)]
        return all_reduce(parts, "sum", [G.device])[0], None


class ShardedDiffSpmm(torch.nn.Module):
    """``Y = A @ X`` (X: (num_cols, F) features) with A row-sharded over
    the mesh, differentiable in X; plus_times fp32.  ``forward(X)``
    returns the (num_rows, F) result on the first mesh device."""

    def __init__(self, m: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None,
                 split_max: int | None | str = "auto"):
        super().__init__()
        cfg = config or SpmvConfig()
        cfgT = configT or cfg
        check_trainable(cfg, "ShardedDiffSpmm")
        check_trainable(cfgT, "ShardedDiffSpmm")
        m = canonicalize(m.astype(np.float32))
        self.m = m
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.cfg, self.cfgT = cfg, cfgT
        self.devices = mesh.device_list()
        self.n_devices = len(self.devices)
        subs, self.rows_per_shard = _row_shards(m, self.n_devices)
        self.num_rows, self.num_cols = m.num_rows, m.num_cols
        self.packsA = _pack_shards(subs, cfg, split_max)
        self.packsT = _pack_shards([csr_to_csc(s) for s in subs], cfgT,
                                   split_max)
        if any(w.col_order is not None for w in self.packsA + self.packsT):
            raise ValueError("col_order reordering is resolved by the "
                             "caller for sharded packs")
        self.opsA = torch.nn.ModuleList(
            SpmvOperator(w, dev) for w, dev in zip(self.packsA, self.devices))
        self.opsT = torch.nn.ModuleList(
            SpmvOperator(w, dev) for w, dev in zip(self.packsT, self.devices))

    def forward(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.devices[0])
        return _ShardedSpmmFn.apply(X, self)


class ShardedGCN(GCN):
    """GCN over a row-sharded packed adjacency: per layer one sharded
    aggregation (:class:`ShardedDiffSpmm`, its all_gather included) and
    one projection on the first mesh device, where the parameters live.
    Parameters, :meth:`load_params` and the forward are
    :class:`~..models.gnn.GCN`'s."""

    def __init__(self, adj: CSRMatrix, mesh: Mesh, dims,
                 config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None, *,
                 normalize: bool = True,
                 split_max: int | None | str = "auto", seed: int = 0):
        torch.nn.Module.__init__(self)
        if len(dims) < 2:
            raise ValueError("dims needs at least [d_in, d_out]")
        a = gcn_normalize(adj) if normalize else adj
        agg = ShardedDiffSpmm(a, mesh, config=config, configT=configT,
                              split_max=split_max)
        self._init_layers(agg, dims, seed, agg.devices[0])
