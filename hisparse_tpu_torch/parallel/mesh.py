"""Sharded SpMV over a device mesh: the port of
``hisparse_tpu/parallel/mesh.py``.

The reference scales out by channels: 16 clusters, each bound to one HBM
pseudo-channel, rows dealt to them, x broadcast to all, the y shards merged
(spmv.ini:15-30, stream_utils.h:8-75).  Here the clusters are the devices
of a :class:`Mesh`:

  * cluster        -> shard (mesh axis "rows"), on its mesh device
  * row assignment -> contiguous row shards, each packed on its own
  * x broadcast    -> one copy of x to each shard's device
  * result merge   -> disjoint natural-order row shards, concatenated

One process drives every shard, as ``jax.sharding.Mesh`` is driven by one
controller.  A :class:`Mesh` is a grid of ``torch.device`` with axis
names; a device may repeat, so four shards can share ``cuda:0`` on one
card and take ``cuda:0`` .. ``cuda:3`` on a node of four.  The collectives
(:func:`all_gather`, :func:`all_reduce`) are torch ops over a list of
per-shard tensors in mesh order, and :func:`all_reduce` folds in that
order from part 0, so its result has the same bits on every run.

Each shard runs its own pack as it comes from the packer: one
:class:`SpmvOperator` a shard needs no common geometry, so the shards are
not padded to the largest one's tile and block count as the JAX package
pads its stacks to make them rectangular.  A shard is the JAX package's
shard before that padding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import LANES, SpmvConfig
from ..formats.csr import CSRMatrix, argsort_rows_by_nnz, split_rows
from ..formats.wavepack import pack
from ..models.perf_model import HBM_GBPS, estimate_pack
from ..ops.spmv import SpmvOperator, fixed_bits, fold_plan, row_fold

# each semiring's additive collective (psum / pmin / pmax)
SEMIRING_REDUCE = {"plus_times": "sum", "min_plus": "min",
                   "max_times": "max"}
_REDUCE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


class Mesh:
    """A grid of ``torch.device`` with one name per axis: the counterpart
    of ``jax.sharding.Mesh`` for one controller process.

    ``devices`` is anything ``np.asarray`` shapes into the grid (devices
    or their names); ``axis_names`` names its axes, one each.  Devices may
    repeat.  A CUDA device raises ``RuntimeError`` where there is no card
    (or no card of its index): nothing falls back to the CPU."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if len(axis_names) != grid.ndim or len(set(axis_names)) != grid.ndim:
            raise ValueError(f"a mesh of {grid.ndim} axes needs as many "
                             f"distinct axis names, got {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = np.empty(grid.size, dtype=object)
        for i, d in enumerate(grid.reshape(-1)):
            d = torch.device(d)
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(f"mesh device {d}: no CUDA device "
                                       "(torch.cuda.is_available() is "
                                       "false)")
                d = torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                if d.index >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"mesh device {d}: this host has "
                        f"{torch.cuda.device_count()} CUDA devices")
            flat[i] = d
        self.devices = flat.reshape(grid.shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self) -> list:
        """The devices in mesh order (row-major over the axes)."""
        return list(self.devices.reshape(-1))


def all_gather(parts, dim: int = 0, devices=None) -> list:
    """Concatenate per-shard tensors (mesh order) along ``dim``, then one
    copy to each target device: ``jax.lax.all_gather(..., tiled=True)``.
    The targets are the parts' devices unless ``devices`` names others;
    returns one tensor per target."""
    full = torch.cat([p.to(parts[0].device) for p in parts], dim)
    targets = [p.device for p in parts] if devices is None else devices
    return [full.to(d) for d in targets]


def all_reduce(parts, op: str = "sum", devices=None) -> list:
    """Elementwise sum, min or max of per-shard tensors (``psum`` /
    ``pmin`` / ``pmax``), folded in ascending mesh order from part 0 on
    part 0's device, so the result has the same bits on every run; then
    one copy to each target device (the parts' unless ``devices`` names
    others).  min and max propagate a NaN."""
    if op not in _REDUCE:
        raise ValueError(f"unknown reduction {op!r}; one of {sorted(_REDUCE)}")
    acc = parts[0]
    for p in parts[1:]:
        acc = _REDUCE[op](acc, p.to(acc.device))
    targets = [p.device for p in parts] if devices is None else devices
    return [acc.to(d) for d in targets]


def ring_allreduce_time(bytes_per_shard: int, n_shards: int,
                        link_gbps: float) -> float:
    """Modelled ring all-reduce time over one mesh axis: reduce-scatter +
    all-gather, 2*(n-1)/n * bytes / bandwidth, per-hop latency ignored
    (the JAX package's ``ici_allreduce_time``).  ``link_gbps`` is the
    link's bandwidth in GB/s, which the caller must give: the port holds
    no measured figure of any interconnect."""
    if n_shards <= 1:
        return 0.0
    return (2 * (n_shards - 1) / n_shards) * bytes_per_shard \
        / (link_gbps * 1e9)


def ring_allgather_time(bytes_total: int, n_shards: int,
                        link_gbps: float) -> float:
    """Modelled ring all-gather of ``bytes_total`` from per-shard pieces:
    (n-1)/n * bytes / bandwidth (the JAX package's
    ``dcn_allgather_time``); ``link_gbps`` as in
    :func:`ring_allreduce_time`."""
    if n_shards <= 1:
        return 0.0
    return ((n_shards - 1) / n_shards) * bytes_total / (link_gbps * 1e9)


def _pack_shards(subs, cfg, split_max, row_orders=None) -> list:
    """Pack every shard, one after another: the shards are independent
    units, as the reference packs each channel on its own
    (sw/data_formatter.h:410), but the native scheduler runs one plan at
    a time (``formats/native``), and a thread pool measured no faster on
    an H100 machine's host (PERF.md, the mesh tier).  The JAX package
    forks a process pool here; a fork after torch has started its thread
    pools or CUDA can deadlock."""
    orders = [None] * len(subs) if row_orders is None else row_orders
    return [pack(s, cfg, row_order=o, split_max=split_max)
            for s, o in zip(subs, orders)]


def _row_slice(m: CSRMatrix, r0: int, r1: int) -> CSRMatrix:
    """Rows [r0, r1) of m, all its columns."""
    return CSRMatrix(r1 - r0, m.num_cols,
                     m.data[m.indptr[r0]:m.indptr[r1]],
                     m.indices[m.indptr[r0]:m.indptr[r1]],
                     np.asarray(m.indptr[r0:r1 + 1] - m.indptr[r0]))


def _float_x(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class ShardedSpmv:
    """Row-sharded SpMV over the whole mesh (its devices in mesh order).

    Rows are split into ``mesh.size`` contiguous shards; each is packed on
    its own (the packer balances load within a shard by nnz-sorting) and
    runs as one :class:`SpmvOperator` on its mesh device, x copied to
    each.  ``__call__`` returns each shard's renamed y; :meth:`unpack_y`
    assembles natural y.

    The JAX package's ``variant=`` (the TPU's resident or paged kernel)
    has no counterpart: one kernel serves packs of any number of column
    partitions."""

    def __init__(self, m: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None,
                 split_max: int | None | str = None):
        cfg = config or SpmvConfig()
        self.cfg = cfg
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        devices = mesh.device_list()
        nd = len(devices)
        rows_per_shard = -(-m.num_rows // nd)
        self.rows_per_shard = rows_per_shard
        subs = []
        for d in range(nd):
            r0 = d * rows_per_shard
            r1 = max(min(m.num_rows, r0 + rows_per_shard), r0)
            subs.append(_row_slice(m, r0, r1))
        self.shards = _pack_shards(subs, cfg, split_max)
        self.ops = [SpmvOperator(wp, dev)
                    for wp, dev in zip(self.shards, devices)]

    def __call__(self, x) -> list:
        """Each shard's renamed y (its operator's ``renamed=True`` output,
        on its device) for natural-order x; a Q8.24 pack takes x as Q8.24
        words or floats to quantize, as :class:`SpmvOperator` does."""
        x = fixed_bits(x) if self.cfg.dtype == "fixed" else _float_x(x)
        return [op(x.to(op.device), renamed=True) for op in self.ops]

    def unpack_y(self, ys) -> torch.Tensor:
        """Natural-order y from the shards' renamed y: each shard folds on
        its device (``SpmvOperator.fold``, the fixed order of
        ``Wavepack.unpack_y``; Q8.24 words in its saturating sum) and the
        shards gather on the first mesh device.  A Q8.24 pack's y comes
        back in one copy, as a uint32 CPU tensor, as
        :class:`SpmvOperator`'s forward gives it."""
        parts = [op.fold(y.view(torch.int32) if self.cfg.dtype == "fixed"
                         else y) for op, y in zip(self.ops, ys)]
        y = all_gather(parts, 0, [self.ops[0].device])[0]
        return y.cpu().view(torch.uint32) if self.cfg.dtype == "fixed" else y

    def perf_estimate(self, hbm_gbps: float = HBM_GBPS,
                      rates: dict | None = None):
        """(per-shard ``estimate_pack``, aggregate GOPS): with each shard
        on a device of its own, the slowest binds the step; the rates are
        the card's (``models/perf_model``)."""
        ests = [estimate_pack(wp, hbm_gbps, rates) for wp in self.shards]
        t_step = max(e.time_s for e in ests)
        nnz = sum(wp.nnz for wp in self.shards)
        return ests, 2 * nnz / t_step / 1e9


class ShardedSpmv2D:
    """Row x column sharded SpMV over a 2-D mesh (axes (rows, cols)): the
    distributed form of the reference's 2-D tiling (row partitions x
    column partitions, sw/host.cpp:150-151).  Piece (i, j) holds row shard
    i restricted to column shard j, on mesh device (i, j), and reads only
    its slice x_j of x (:meth:`shard_x`); the partial y_i of a row shard
    combine over "cols" with the semiring's collective (:func:`all_reduce`
    with sum, min or max, in mesh order).

    The collective adds renamed rows slot for slot, so a row shard's
    pieces must share one renamed layout: hub splitting and the row order
    are settled once per row shard, on the whole shard, and each piece is
    packed with that ``row_order`` and no splitting.  Q8.24 packs raise
    ``ValueError`` (a saturating sum of partials is not the saturating
    sum of the terms)."""

    def __init__(self, m: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None,
                 split_max: int | None | str = None):
        cfg = config or SpmvConfig()
        if cfg.dtype == "fixed":
            raise ValueError("2-D sharding combines partials with a "
                             "collective; fixed-point recombine saturates "
                             "(use ShardedSpmv + host unpack)")
        if len(mesh.axis_names) != 2:
            raise ValueError("ShardedSpmv2D needs a mesh of two axes "
                             "(rows, cols)")
        self.cfg = cfg
        self.mesh = mesh
        self.ar, self.ac = mesh.axis_names
        nr, nc = mesh.shape
        if split_max == "auto":
            mean = max(float(m.nnz) / max(m.num_rows, 1), 1.0)
            split_max = max(8, 1 << int(round(np.log2(mean))))
        rows_per_shard = -(-m.num_rows // nr)
        cols_per_shard = -(-m.num_cols // nc)
        self.cols_per_shard = cols_per_shard
        pieces, orders, self.row_maps, self.row_counts = [], [], [], []
        for i in range(nr):
            r0 = min(m.num_rows, i * rows_per_shard)
            r1 = min(m.num_rows, r0 + rows_per_shard)
            sub = _row_slice(m, r0, r1)
            # split + order ONCE per row shard -> common renamed layout
            if split_max is not None:
                sub, row_map = split_rows(sub, split_max)
            else:
                row_map = np.arange(sub.num_rows, dtype=np.int64)
            order = argsort_rows_by_nnz(sub, descending=True)
            self.row_maps.append(row_map)
            self.row_counts.append(r1 - r0)
            for j in range(nc):
                c0 = min(m.num_cols, j * cols_per_shard)
                c1 = min(m.num_cols, c0 + cols_per_shard)
                sel = (sub.indices >= c0) & (sub.indices < c1)
                cnt = np.zeros(sub.num_rows, np.int64)
                np.add.at(cnt, np.repeat(np.arange(sub.num_rows),
                                         np.diff(sub.indptr))[sel], 1)
                pieces.append(CSRMatrix(
                    sub.num_rows, max(c1 - c0, 1),
                    sub.data[sel], sub.indices[sel] - c0,
                    np.concatenate([[0], np.cumsum(cnt)])))
                orders.append(order)
        # a row shard's pieces have its row count and order, so one
        # renamed layout (perm and block count) for the "cols" combine
        flat = _pack_shards(pieces, cfg, None, orders)
        self.grid = [flat[i * nc:(i + 1) * nc] for i in range(nr)]
        self.ops = [[SpmvOperator(wp, mesh.devices[i, j])
                     for j, wp in enumerate(row)]
                    for i, row in enumerate(self.grid)]
        # each row shard's fold, renamed -> natural rows, on device (i, 0):
        # its split rows' partials in ascending split-row order, the order
        # of the JAX package's host unpack (unpack_y, then the row_map fold)
        self.folds = []
        for i, row in enumerate(self.grid):
            perm, row_map = row[0].perm, self.row_maps[i]
            n_split = row_map.shape[0]
            valid = np.flatnonzero(perm < n_split)
            at = np.empty(n_split, np.int64)
            at[perm[valid]] = valid
            idx, ptr, long_rows = fold_plan(row_map, self.row_counts[i])
            dev = mesh.devices[i, 0]
            self.folds.append(tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in (at[idx], ptr, long_rows)))

    def shard_x(self, x) -> torch.Tensor:
        """Natural-order x -> the (n_col_shards, cols_per_shard) slices
        the pieces read, zero-padded."""
        x = _float_x(x)
        nc, w = self.mesh.shape[1], self.cols_per_shard
        out = torch.zeros(nc * w, dtype=x.dtype, device=x.device)
        out[:x.shape[0]] = x
        return out.reshape(nc, w)

    def __call__(self, x) -> list:
        """x: natural order (sliced here) or :meth:`shard_x`'s slices.
        Returns each row shard's renamed y, combined over "cols", on mesh
        device (i, 0)."""
        x = _float_x(x)
        xs = self.shard_x(x) if x.dim() == 1 else x
        op_name = SEMIRING_REDUCE[self.cfg.semiring]
        out = []
        for row in self.ops:
            ys = [op(xs[j, :op.wp.num_cols].to(op.device), renamed=True)
                  for j, op in enumerate(row)]
            out.append(all_reduce(ys, op_name, [row[0].device])[0])
        return out

    def unpack_y(self, ys) -> torch.Tensor:
        """Natural-order y: per row shard, one fold (``row_fold``) undoes
        the common renamed layout and combines hub-split partials (max_times
        clamped at 0, as the JAX package's host unpack does); the row shards
        gather on the first mesh device."""
        parts = [row_fold(y.contiguous(), *fold, self.cfg.semiring)
                 for y, fold in zip(ys, self.folds)]
        return all_gather(parts, 0, [self.mesh.devices.reshape(-1)[0]])[0]

    def perf_estimate(self, hbm_gbps: float = HBM_GBPS,
                      link_gbps: float | None = None,
                      rates: dict | None = None):
        """(per-piece estimates, aggregate GOPS, t_compute_s, t_combine_s):
        the slowest piece binds the step, plus the "cols" combine of a row
        shard's renamed y (:func:`ring_allreduce_time` over ``link_gbps``).
        Without ``link_gbps`` the combine term and the aggregate are
        ``None``: unmeasured."""
        ests = [[estimate_pack(wp, hbm_gbps, rates) for wp in row]
                for row in self.grid]
        t_comp = max(e.time_s for row in ests for e in row)
        nc = self.mesh.shape[1]
        y_bytes = max(row[0].n_blocks for row in self.grid) \
            * self.cfg.stripes * LANES * 4
        t_comb = (None if link_gbps is None
                  else ring_allreduce_time(y_bytes, nc, link_gbps))
        nnz = sum(wp.nnz for row in self.grid for wp in row)
        gops = (None if t_comb is None
                else 2 * nnz / (t_comp + t_comb) / 1e9)
        return ests, gops, t_comp, t_comb


class ShardedSpmvMultiHost(ShardedSpmv2D):
    """A (hosts x chips-per-host) mesh: rows shard over the first axis,
    columns over the second, and the semiring combine runs over the
    second axis only, inside a host, so a step needs no collective across
    hosts (row ownership is disjoint, the reference's channel merge,
    stream_utils.h:35-75).  Between chained steps (PageRank) each host's y
    shard is gathered to every host: :meth:`perf_estimate`'s host term.
    The numbers are :class:`ShardedSpmv2D`'s."""

    def __init__(self, m: CSRMatrix, mesh: Mesh,
                 config: SpmvConfig | None = None,
                 split_max: int | None | str = None):
        if len(mesh.axis_names) != 2:
            raise ValueError(
                "multi-host mesh needs exactly (hosts, chips) axes")
        super().__init__(m, mesh, config=config, split_max=split_max)
        self.n_hosts, self.chips_per_host = mesh.shape

    def perf_estimate(self, hbm_gbps: float = HBM_GBPS,
                      link_gbps: float | None = None,
                      host_gbps: float | None = None,
                      chained: bool = True, rates: dict | None = None):
        """(per-piece estimates, aggregate GOPS, t_compute_s, t_link_s,
        t_host_s): ``t_link_s`` is the chips-axis combine over
        ``link_gbps``; ``t_host_s`` the x redistribution between steps over
        ``host_gbps`` (:func:`ring_allgather_time`), 0 when ``chained`` is
        false.  A term whose bandwidth is not given is ``None``, and so is
        the aggregate."""
        ests, _, t_comp, t_link = super().perf_estimate(hbm_gbps, link_gbps,
                                                        rates)
        t_host = 0.0
        if chained:
            itemsize = 2 if self.cfg.dtype == "bf16" else 4
            x_bytes = self.grid[0][0].num_cols * self.chips_per_host \
                * itemsize
            t_host = (None if host_gbps is None else ring_allgather_time(
                x_bytes, self.n_hosts, host_gbps))
        nnz = sum(wp.nnz for row in self.grid for wp in row)
        gops = (None if t_link is None or t_host is None
                else 2 * nnz / (t_comp + t_link + t_host) / 1e9)
        return ests, gops, t_comp, t_link, t_host
