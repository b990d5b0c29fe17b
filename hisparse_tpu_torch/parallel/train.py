"""Distributed training step: the sharded differentiable SpMV, the port of
``hisparse_tpu/parallel/train.py``.

:class:`ShardedDiffSpmv` is the mesh form of :class:`~..ops.autodiff.
DiffSpmv`: ``y = A @ x`` differentiable in the values of A and in x, with
A row-sharded over the mesh like :class:`~.mesh.ShardedSpmv`:

  * forward: shard d runs its SpMV kernel on its rows A_d with x copied
    to its device, then its fixed-order fold (``row_fold``) to its natural
    rows; the disjoint row shards concatenate, with no reduction;
  * ``dL/dx = A^T g``: shard d runs a second pack, of A_d^T, on its own
    rows of the cotangent, giving a full-length partial; the partials sum
    in one :func:`~.mesh.all_reduce` (the data-parallel gradient
    all-reduce);
  * ``dL/dvals``: two gathers a shard, no kernel, no collective.

The values are one tensor a shard (``vals[d]``, the shard's CSR-order
values; :meth:`ShardedDiffSpmv.stack_values` splits a global vector), on
the shard's device; each call scatters them into the shard's two streams.
:class:`ShardedStreamDiffSpmv` trains the streams themselves, with the
gradient-stream kernel on every shard.

Each shard's rows are padded to ``rows_per_shard`` (:func:`_row_shards`),
as the JAX package pads them, so a natural-order vector splits into the
shards and gathers back in equal strides; an empty row holds no tile.
The shards' tile streams are not padded (:mod:`.mesh`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix, csr_to_csc
from ..ops.autodiff import (canonicalize, check_trainable, emit_vals,
                            steal_src_bits, wp_stream_map)
from ..ops.spmv import SpmvOperator, wavepack_gradstream
from ..ops.train_stream import grad_stream_operands, with_bits
from .mesh import Mesh, _pack_shards, all_gather, all_reduce


def _row_shards(m: CSRMatrix, nd: int):
    """Contiguous row shards, each padded with empty rows to
    ``rows_per_shard`` rows (an empty row costs no slot): the shard's rows
    of a natural-order vector are one equal stride of it."""
    rows_per_shard = -(-m.num_rows // nd)
    subs = []
    for d in range(nd):
        r0 = min(m.num_rows, d * rows_per_shard)
        r1 = min(m.num_rows, r0 + rows_per_shard)
        indptr = m.indptr[r0:r1 + 1] - m.indptr[r0]
        indptr = np.concatenate(
            [indptr, np.full(rows_per_shard - (r1 - r0), indptr[-1],
                             indptr.dtype)])
        subs.append(CSRMatrix(rows_per_shard, m.num_cols,
                              m.data[m.indptr[r0]:m.indptr[r1]],
                              m.indices[m.indptr[r0]:m.indptr[r1]],
                              np.asarray(indptr)))
    return subs, rows_per_shard


def split_rows_to(g: torch.Tensor, rows_per_shard: int, devices) -> list:
    """A natural-order (num_rows, ...) tensor -> each shard's
    ``rows_per_shard`` rows on its device, zero-padded past num_rows."""
    n = len(devices) * rows_per_shard
    gp = g.new_zeros((n,) + tuple(g.shape[1:]))
    gp[:g.shape[0]] = g
    return [p.to(d) for p, d in zip(gp.split(rows_per_shard), devices)]


def gather_rows(parts, num_rows: int, device) -> torch.Tensor:
    """The shards' natural rows (mesh order) -> the global (num_rows, ...)
    tensor on ``device``."""
    return all_gather(parts, 0, [device])[0][:num_rows]


def _buf(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


class _ShardedDiffSpmvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sd, x, *vs):
        ctx.sd = sd
        ctx.save_for_backward(x, *vs)
        ys = [op(x.to(op.device), vals=emit_vals(
                  v, sd.mapA[d], sd.srcA[d], sd.cfg.steal_mantissa,
                  op.vals.shape))
              for d, (op, v) in enumerate(zip(sd.opsA, vs))]
        return gather_rows(ys, sd.num_rows, x.device)

    @staticmethod
    def backward(ctx, g):
        x, *vs = ctx.saved_tensors
        sd = ctx.sd
        gs = split_rows_to(g, sd.rows_per_shard, sd.devices)
        x_bar = None
        if ctx.needs_input_grad[1]:
            parts = [op(g_d, vals=emit_vals(
                         v, sd.mapT[d], sd.srcT[d], sd.cfgT.steal_mantissa,
                         op.vals.shape))
                     for d, (op, v, g_d) in enumerate(zip(sd.opsT, vs, gs))]
            x_bar = all_reduce(parts, "sum", [x.device])[0].to(x.dtype)
        v_bars = [(g_d[sd.rows[d]] * x.to(g_d.device)[sd.cols[d]]).to(v.dtype)
                  if ctx.needs_input_grad[2 + d] else None
                  for d, (v, g_d) in enumerate(zip(vs, gs))]
        return (None, x_bar, *v_bars)


class ShardedDiffSpmv(torch.nn.Module):
    """Row-sharded differentiable SpMV (plus_times fp32 only: fixed point
    has no tangent space, and min / max gradients are subgradients).

    The parameters ``vals[d]`` are shard d's CSR-order values (of the
    canonical matrix ``self.m``: sorted, duplicates summed, no explicit
    zeros), on its mesh device; ``forward(x, vals=None)`` returns the
    natural-order y (num_rows,) on the first mesh device.  The packs of
    each shard's A_d and A_d^T run as :class:`SpmvOperator`s on its
    device."""

    def __init__(self, m: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None,
                 split_max: int | None | str = "auto"):
        super().__init__()
        cfg = config or SpmvConfig()
        cfgT = configT or cfg
        check_trainable(cfg, "ShardedDiffSpmv")
        check_trainable(cfgT, "ShardedDiffSpmv")
        m = canonicalize(m.astype(np.float32))
        self.m = m
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.cfg, self.cfgT = cfg, cfgT
        self.devices = mesh.device_list()
        self.n_devices = nd = len(self.devices)
        subs, self.rows_per_shard = _row_shards(m, nd)
        self.num_rows, self.num_cols = m.num_rows, m.num_cols

        self.packsA = packsA = _pack_shards(subs, cfg, split_max)
        self.packsT = packsT = _pack_shards([csr_to_csc(s) for s in subs],
                                            cfgT, split_max)
        mapsA, mapsT, rowsv, colsv = [], [], [], []
        for sub, wa, wt in zip(subs, packsA, packsT):
            linA, rowsA, colsA = wp_stream_map(wa)
            rows_csr = np.repeat(np.arange(sub.num_rows),
                                 np.diff(sub.indptr).astype(np.int64))
            linT, rowsT, colsT = wp_stream_map(wt)
            ordT = np.lexsort((rowsT, colsT))
            if not (np.array_equal(rowsA, rows_csr)
                    and np.array_equal(colsA, sub.indices.astype(np.int64))
                    and np.array_equal(colsT[ordT], rows_csr)):
                raise ValueError("a shard pack's slot map does not "
                                 "enumerate the shard's CSR pattern")
            mapsA.append(linA)
            mapsT.append(linT[ordT])
            rowsv.append(rows_csr)
            colsv.append(sub.indices.astype(np.int64))
        if any(w.col_order is not None for w in self.packsA):
            raise ValueError("col_order reordering is resolved by the "
                             "caller for sharded packs")
        self.opsA = torch.nn.ModuleList(
            SpmvOperator(w, dev) for w, dev in zip(self.packsA, self.devices))
        self.opsT = torch.nn.ModuleList(
            SpmvOperator(w, dev) for w, dev in zip(self.packsT, self.devices))
        self.nnz_shard = [len(v) for v in mapsA]
        devs = self.devices
        self.mapA = [_buf(v, np.int64, d) for v, d in zip(mapsA, devs)]
        self.mapT = [_buf(v, np.int64, d) for v, d in zip(mapsT, devs)]
        self.rows = [_buf(v, np.int64, d) for v, d in zip(rowsv, devs)]
        self.cols = [_buf(v, np.int64, d) for v, d in zip(colsv, devs)]

        def src(packs, steal):
            return [_buf(steal_src_bits(w.vals) if steal
                         else np.zeros(1, np.int32), np.int32, d)
                    for w, d in zip(packs, devs)]

        self.srcA = src(self.packsA, cfg.steal_mantissa)
        self.srcT = src(self.packsT, cfgT.steal_mantissa)
        self.vals = torch.nn.ParameterList(
            torch.nn.Parameter(v) for v in self.stack_values(m.data))

    # -- value layout helpers ------------------------------------------
    def stack_values(self, v_global) -> list:
        """Global CSR-order values -> one float32 tensor a shard, on its
        device (rows are contiguous shards, so the shards' slices
        concatenate back to the global vector)."""
        v = np.asarray(v_global, np.float32)
        ends = np.cumsum(self.nnz_shard)
        return [_buf(v[e - n:e], np.float32, d)
                for n, e, d in zip(self.nnz_shard, ends, self.devices)]

    @staticmethod
    def unstack_values(vs) -> np.ndarray:
        """Per-shard values (or gradients) -> the global CSR-order
        vector."""
        return np.concatenate([v.detach().cpu().numpy() for v in vs])

    def forward(self, x, vals=None) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.devices[0])
        vs = self.vals if vals is None else vals
        return _ShardedDiffSpmvFn.apply(self, x, *vs)


class _ShardedStreamFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sd, x, *streams):
        ctx.sd = sd
        ctx.save_for_backward(x, *streams)
        d = sd.d
        vA = streams[:d.n_devices]
        ys = [op(x.to(op.device), vals=v) for op, v in zip(d.opsA, vA)]
        return gather_rows(ys, d.num_rows, x.device)

    @staticmethod
    def backward(ctx, g):
        x, *streams = ctx.saved_tensors
        sd = ctx.sd
        d = sd.d
        nd = d.n_devices
        vA, vT = streams[:nd], streams[nd:]
        need = ctx.needs_input_grad
        gs = split_rows_to(g, d.rows_per_shard, d.devices)
        xs = [x.to(dev) for dev in d.devices]
        # each view of the one parameter gets its own copy of dL/dvals
        gA = [wavepack_gradstream(*grad_stream_operands(
                  op, v, mk, g_d, x_d)) if need[2 + i] else None
              for i, (op, v, mk, g_d, x_d) in enumerate(
                  zip(d.opsA, vA, sd.maskA, gs, xs))]
        gT = [wavepack_gradstream(*grad_stream_operands(
                  op, v, mk, x_d, g_d)) if need[2 + nd + i] else None
              for i, (op, v, mk, g_d, x_d) in enumerate(
                  zip(d.opsT, vT, sd.maskT, gs, xs))]
        x_bar = None
        if need[1]:
            parts = [op(g_d, vals=v) for op, v, g_d in zip(d.opsT, vT, gs)]
            x_bar = all_reduce(parts, "sum", [x.device])[0].to(x.dtype)
        return (None, x_bar, *gA, *gT)


class ShardedStreamDiffSpmv(torch.nn.Module):
    """Distributed stream-layout training: the mesh form of
    :class:`~..ops.train_stream.StreamDiffSpmv`.

    Each shard's parameters are its two packed value streams, ``vA[d]``
    (the A_d pack's) and ``vT[d]`` (the A_d^T pack's), on its device; the
    backward gives each its gradient in its own layout through the
    gradient-stream kernel, and the one collective stays the
    :func:`~.mesh.all_reduce` of ``dL/dx``.  Elementwise updates
    (:meth:`sgd_step`) keep all 2 * n_devices layout copies bit-consistent
    (see ``ops/train_stream.py``).  ``self.d`` is the
    :class:`ShardedDiffSpmv` over the same packs (its ``vals`` are not
    used here)."""

    def __init__(self, m: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None,
                 split_max: int | None | str = "auto"):
        super().__init__()
        d = ShardedDiffSpmv(m, mesh, config, configT, split_max)
        self.d = d
        self.m = d.m
        self.num_rows, self.num_cols = d.num_rows, d.num_cols

        def mask(op, lin):
            mk = torch.zeros(op.vals.numel(), dtype=torch.float32,
                             device=op.device)
            mk[lin] = 1.0
            return mk.reshape(op.vals.shape)

        self.maskA = [mask(op, lin) for op, lin in zip(d.opsA, d.mapA)]
        self.maskT = [mask(op, lin) for op, lin in zip(d.opsT, d.mapT)]
        self.splantA = ([s.reshape(op.vals.shape)
                         for s, op in zip(d.srcA, d.opsA)]
                        if d.cfg.steal_mantissa else None)
        self.splantT = ([s.reshape(op.vals.shape)
                         for s, op in zip(d.srcT, d.opsT)]
                        if d.cfgT.steal_mantissa else None)
        self.vA = torch.nn.ParameterList(
            torch.nn.Parameter(op.vals.clone()) for op in d.opsA)
        self.vT = torch.nn.ParameterList(
            torch.nn.Parameter(op.vals.clone()) for op in d.opsT)

    # -- value plumbing: host readback for checks -----------------------
    @staticmethod
    def _read(vs, maps, steal: bool) -> np.ndarray:
        out = np.concatenate([v.detach().reshape(-1)[lin].cpu().numpy()
                              for v, lin in zip(vs, maps)])
        if steal:
            out = (out.view(np.uint32)
                   & np.uint32(0xFFFFFF80)).view(np.float32)
        return out

    def values(self, vA=None) -> np.ndarray:
        """Global CSR-order values read back from the A-layout streams."""
        return self._read(self.vA if vA is None else vA, self.d.mapA,
                          self.d.cfg.steal_mantissa)

    def values_T(self, vT=None) -> np.ndarray:
        """Global CSR-order values read back from the A^T-layout
        streams."""
        return self._read(self.vT if vT is None else vT, self.d.mapT,
                          self.d.cfgT.steal_mantissa)

    def grads_csr(self, gA) -> np.ndarray:
        """Global CSR-order dL/dvals read back from A-layout gradients."""
        return self._read(gA, self.d.mapA, False)

    def grads_csr_T(self, gT) -> np.ndarray:
        """Global CSR-order dL/dvals read back from A^T-layout
        gradients."""
        return self._read(gT, self.d.mapT, False)

    # -- elementwise updates ---------------------------------------------
    @staticmethod
    def _bits(vs, plants, replant: bool) -> list:
        """Each shard's stream with its steal-mantissa bits cleared and,
        if ``replant``, set again; the streams as they are for a pack
        that steals none (``plants`` None)."""
        if plants is None:
            return list(vs)
        return [with_bits(v, p if replant else None)
                for v, p in zip(vs, plants)]

    def clean(self, vA, vT):
        """Each shard's streams with their planted src bits stripped
        (identity for non-steal packs)."""
        return (self._bits(vA, self.splantA, False),
                self._bits(vT, self.splantT, False))

    def replant(self, vA, vT):
        """Re-truncate and re-plant the steal-mantissa src bits after an
        elementwise update (identity for non-steal packs)."""
        return (self._bits(vA, self.splantA, True),
                self._bits(vT, self.splantT, True))

    @torch.no_grad()
    def sgd_step(self, lr: float, gA=None, gT=None) -> None:
        """One SGD step on every shard's two layouts, in place: clean ->
        ``v - lr*g`` -> replant.  ``gA`` / ``gT`` (one tensor a shard)
        default to the parameters' ``.grad``."""
        gA = [v.grad for v in self.vA] if gA is None else gA
        gT = [v.grad for v in self.vT] if gT is None else gT
        vA, vT = self.clean(self.vA, self.vT)
        vA, vT = self.replant([v - lr * g for v, g in zip(vA, gA)],
                              [v - lr * g for v, g in zip(vT, gT)])
        for p, v in zip(list(self.vA) + list(self.vT), vA + vT):
            p.copy_(v)

    def forward(self, x, vA=None, vT=None) -> torch.Tensor:
        """Natural-order y (num_rows,) on the first mesh device."""
        d = self.d
        x = torch.as_tensor(x, dtype=torch.float32, device=d.devices[0])
        return _ShardedStreamFn.apply(
            self, x, *(self.vA if vA is None else vA),
            *(self.vT if vT is None else vT))
