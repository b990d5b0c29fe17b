"""Graph apps on top of the packed SpMV: PageRank (plus_times), SSSP
(min_plus) and BFS (max_times), the port of ``hisparse_tpu/models/apps.py``.

Each app packs its matrix with a column order equal to its row order, so
an iteration feeds y straight back as x in the renamed (packed) space,
with no permutation.  Hub rows split by the packer are recombined on the
device by one fold (``row_fold``) from the pack's renamed y straight to
rank order: each rank's partials in ascending renamed order, in the
app's algebra.  The JAX package recombines them by a combine tree of
wavepack SpMVs over 0/1 selection matrices; its counterpart here
(``build_combine``, ``apply_combine``) is kept for the tests that hold
the two packages' trees byte-equal, and the apps do not run it.  Each app
is an ``nn.Module`` that holds its ``SpmvOperator`` and fold plan; state
stays on the device across iterations, and each iteration reads one value
back to the host: the convergence test (SSSP's ``changed``, BFS's new
frontier).  The masked runs (``masked=True``) stream only the tiles an
iteration's frontier can touch (``SpmvOperator.masked_tiles``); they also
bring the frontier's indices back for the tile selection
(``SpmvOperator.active_tiles``).

The JAX package's jit plumbing (``step_fn``, ``_op_args``, ``_op_call``)
becomes a ``step`` method: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import (CSRMatrix, argsort_rows_by_nnz, csr_to_csc,
                           normalize_by_outdegree)
from ..formats.wavepack import Wavepack, pack
from ..ops.spmv import SpmvOperator, algebra, fold_plan, row_fold
from ..utils.tracing import span


def y_to_rank(wp: Wavepack, y_renamed: torch.Tensor) -> torch.Tensor:
    """Transpose a y-layout result into rank layout: rank rho lives at y
    slot (rho % n_blocks, (rho // n_blocks) % R, (rho // n_blocks) // R),
    so rank order is the (lane, stripe, block) transpose, flattened."""
    yb = y_renamed.reshape(wp.n_blocks, wp.config.stripes, 128)
    return yb.permute(2, 1, 0).reshape(-1)


def build_combine(wp_A: Wavepack, n_rows: int, order_rows, semiring: str,
                  device="cuda", fanout_cap: int = 32):
    """The on-device partial-combine tree: wavepack SpMVs over 0/1
    selection matrices folding A's hub-split partials back to rank layout,
    with the semiring's identity weights (0 for min_plus, so the combine is
    a min; 1 otherwise).

    The combine takes A's y in rank layout, where a row's virtual partials
    sit at consecutive positions, so the selection columns spread across
    banks.  Each level reduces every row's partials in chunks of
    ``fanout_cap`` until one value a row remains (at most 2 levels in
    practice).  Returns a list of (Wavepack, SpmvOperator), applied in
    order with ``y_to_rank`` between levels (:func:`apply_combine`).  The
    counterpart of the JAX package's tree; the apps fold with
    ``row_fold`` instead."""
    import scipy.sparse as sp
    perm = wp_A.perm
    n_slots_y = perm.shape[0]
    cfg_A = wp_A.config
    NB, R = wp_A.n_blocks, cfg_A.stripes
    # rank r lives at y slot (r%NB)*RPB + ((r//NB)%R)*128 + (r//NB)//R
    ranks = np.arange(n_slots_y)
    yslot_of_rank = ((ranks % NB) * cfg_A.rows_per_block
                     + ((ranks // NB) % R) * 128 + (ranks // NB) // R)
    perm_rank = perm[yslot_of_rank]

    # each input position's target original row (-1 = padding); the
    # positions of one row are consecutive in rank order
    target = np.where(perm_rank < n_rows, perm_rank, -1)
    levels = []
    c_cfg = SpmvConfig(sublanes=512, bank_blocks=8, stripes=512,
                       two_choice=True, semiring=semiring)
    width = n_slots_y
    while True:
        valid = np.nonzero(target >= 0)[0]
        rows_t = target[valid]
        # chunk each row's positions into groups of fanout_cap
        order_pos = np.lexsort((valid, rows_t))
        rt, vp = rows_t[order_pos], valid[order_pos]
        new_row = np.r_[True, rt[1:] != rt[:-1]]
        within = np.arange(rt.size) - np.maximum.accumulate(
            np.where(new_row, np.arange(rt.size), 0))
        chunk = within // fanout_cap
        last_level = (chunk == 0).all()
        if last_level:
            group_ids = rt            # final: group = original row
            n_groups = n_rows
            row_of_group = None
        else:
            key = rt.astype(np.int64) * (within.max() // fanout_cap + 1) + chunk
            uniq, group_ids = np.unique(key, return_inverse=True)
            n_groups = uniq.size
            row_of_group = (uniq // (within.max() // fanout_cap + 1))
        w = (np.zeros(vp.size, np.float32) if semiring == "min_plus"
             else np.ones(vp.size, np.float32))
        C = sp.csr_matrix((w, (group_ids, vp)), shape=(n_groups, width))
        wp_C = pack(CSRMatrix(n_groups, width, np.asarray(C.data, np.float32),
                              np.asarray(C.indices, np.int32),
                              np.asarray(C.indptr, np.int64)),
                    c_cfg, row_order=order_rows if last_level else None)
        levels.append((wp_C, SpmvOperator(wp_C, device, permute_x=False)))
        if last_level:
            return levels
        # the next level's input is this level's rank-layout output
        width = wp_C.n_blocks * c_cfg.rows_per_block
        ranks_C = np.arange(width)
        yslot_C = ((ranks_C % wp_C.n_blocks) * c_cfg.rows_per_block
                   + ((ranks_C // wp_C.n_blocks) % c_cfg.stripes) * 128
                   + (ranks_C // wp_C.n_blocks) // c_cfg.stripes)
        grp_rank = wp_C.perm[yslot_C]
        ok = grp_rank < n_groups
        target = np.where(
            ok, row_of_group[np.minimum(grp_rank, n_groups - 1)], -1)


def apply_combine(levels, y_rank: torch.Tensor) -> torch.Tensor:
    """Fold partials through the combine tree; input and output are rank
    layouts."""
    x = y_rank
    with span("hisparse.combine"):
        for wp_C, op_C in levels:
            x = y_to_rank(wp_C, op_C(x, renamed=True))
    return x


class _App(torch.nn.Module):
    """What the three apps share: the pack of their matrix with a column
    order equal to its row order, the operator and the fold plan from its
    renamed y to rank order on one device, and the maps between natural
    and rank order.  The iterate is the ``n_slots`` = n ranks; ``combine``,
    the selection packs an iteration streams, is empty."""

    def __init__(self, m: CSRMatrix, cfg: SpmvConfig | None, device,
                 split_max="auto"):
        super().__init__()
        self.n = m.num_rows
        order = argsort_rows_by_nnz(m, descending=True)
        self.wp = pack(m, cfg, split_max=split_max, col_order=order)
        self.op = SpmvOperator(self.wp, device, permute_x=False)
        # rank slot inv[v] holds original row v
        self.inv = np.empty(self.n, np.int64)
        self.inv[order] = np.arange(self.n)
        # renamed position i holds a partial of natural row perm[i], so of
        # rank inv[perm[i]]; padding positions (perm >= n) map to n
        perm = self.wp.perm
        rank = np.where(perm < self.n,
                        self.inv[np.minimum(perm, self.n - 1)], self.n)
        for name, a in zip(("fold_idx", "fold_ptr", "fold_long"),
                           fold_plan(rank, self.n)):
            self.register_buffer(name, torch.from_numpy(a).to(
                self.op.device))
        self.combine = []
        self.n_slots = self.n
        self.register_buffer("inv_t", torch.from_numpy(self.inv).to(
            self.op.device))

    @staticmethod
    def _steps(its):
        """The items of ``its``, each iteration of the caller's loop body
        inside a ``hisparse.step`` span (closed at ``break`` too)."""
        for i in its:
            with span("hisparse.step"):
                yield i

    def _fold(self, y: torch.Tensor) -> torch.Tensor:
        """The operator's renamed y -> rank layout: each rank's hub-split
        partials folded in ascending renamed order (:func:`row_fold`)."""
        with span("hisparse.combine"):
            return row_fold(y.contiguous(), self.fold_idx, self.fold_ptr,
                            self.fold_long, algebra(self.wp.config))

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """One matrix apply in rank layout, hub-split rows folded."""
        return self._fold(self.op(x[:self.n], renamed=True))

    def spmv_masked(self, x: torch.Tensor, active: np.ndarray):
        """:meth:`spmv` from only the tiles that can touch the rank-order
        columns ``active``; returns (result, tiles streamed)."""
        tiles = self.op.active_tiles(active)
        y = self.op.masked_tiles(x[:self.n], tiles, renamed=True)
        return self._fold(y), len(tiles)


class PageRank(_App):
    """Power-iteration PageRank on a square adjacency matrix.

    The matrix is column-normalised (1/outdegree) and packed as P A P^T
    with matched row and column renaming; hub rows' partial sums are
    recombined on the device by the fold into rank order, so an iteration
    is the SpMV, the fold and the damping, all on the device."""

    def __init__(self, adj: CSRMatrix, config: SpmvConfig | None = None,
                 damping: float = 0.85, device="cuda", split_max="auto"):
        if adj.num_rows != adj.num_cols:
            raise ValueError("PageRank needs a square adjacency matrix")
        super().__init__(normalize_by_outdegree(adj.astype(np.float32)),
                         config, device, split_max)
        self.damping = damping
        valid = torch.zeros(self.n_slots, dtype=torch.float32)
        valid[:self.n] = 1.0
        self.register_buffer("valid", valid.to(self.op.device))

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One power iteration in rank layout."""
        return (self.damping * self.spmv(x)
                + (1.0 - self.damping) / self.n * self.valid)

    def run(self, iters: int = 20, x0=None) -> torch.Tensor:
        """Run power iterations; returns the PageRank vector in original
        row order, on the device."""
        xr = np.zeros(self.n_slots, np.float32)
        if x0 is None:
            xr[:self.n] = 1.0 / self.n
        else:
            xr[self.inv] = x0
        x = torch.from_numpy(xr).to(self.op.device)
        for _ in self._steps(range(iters)):
            x = self.step(x)
        return x[self.inv_t]


def pagerank(adj: CSRMatrix, iters: int = 20,
             config: SpmvConfig | None = None, damping: float = 0.85,
             device="cuda") -> torch.Tensor:
    return PageRank(adj, config, damping, device=device).run(iters)


def pagerank_reference(adj: CSRMatrix, iters: int = 20,
                       damping: float = 0.85) -> np.ndarray:
    """Numpy golden PageRank (the CPU-model analog)."""
    m = normalize_by_outdegree(adj.astype(np.float64))
    sp = m.to_scipy()
    n = adj.num_rows
    x = np.full(n, 1.0 / n)
    for _ in range(iters):
        x = damping * (sp @ x) + (1 - damping) / n
    return x


class SSSP(_App):
    """Single-source shortest paths by Bellman-Ford over the tropical
    (min, +) semiring: d' = min(d, A_minplus d), on the transposed matrix
    so that y[v] is the least w(u, v) + d[u] over v's in-edges."""

    def __init__(self, adj: CSRMatrix, config: SpmvConfig | None = None,
                 device="cuda"):
        if adj.num_rows != adj.num_cols:
            raise ValueError("SSSP needs a square weighted adjacency matrix")
        cfg = dataclasses.replace(config or SpmvConfig(), semiring="min_plus",
                                  dtype="fp32", steal_mantissa=False)
        super().__init__(csr_to_csc(adj.astype(np.float32)), cfg, device)

    def step(self, x: torch.Tensor):
        """One relaxation in rank layout: ``(x_new, changed)``, changed a
        device bool, whether any distance fell."""
        x_new = torch.minimum(x, self.spmv(x))
        return x_new, (x_new < x).any()

    def run(self, source: int, iters: int | None = None,
            masked: bool = False) -> torch.Tensor:
        """Bellman-Ford to the relaxation fixpoint: each step also says
        whether any distance fell, so the loop ends after O(diameter)
        iterations; ``iters`` caps it (default n - 1).  Returns the
        distances in original order, on the device; ``iters_run`` counts
        the iterations.

        ``masked=True`` runs sparse Bellman-Ford: each step streams only
        the tiles that can touch a distance that changed in the last step
        (``tiles_streamed`` lists how many).  Right because distances only
        fall: the contributions of unchanged columns are already in the
        running minimum."""
        iters = iters if iters is not None else self.n - 1
        dev = self.op.device
        x = torch.full((self.n_slots,), float("inf"), device=dev)
        x[int(self.inv[source])] = 0.0
        self.iters_run = 0
        self.tiles_streamed = []
        if masked:
            changed = torch.zeros(self.n_slots, dtype=torch.bool, device=dev)
            changed[int(self.inv[source])] = True
            for _ in self._steps(range(iters)):
                with span("hisparse.sync"):
                    act = torch.nonzero(
                        changed[:self.n]).squeeze(1).cpu().numpy()
                if len(act) == 0:
                    break
                y, n_tiles = self.spmv_masked(x, act)
                self.tiles_streamed.append(n_tiles)
                x_new = torch.minimum(x, y)
                changed = x_new < x
                x = x_new
                self.iters_run += 1
            return x[self.inv_t]
        for _ in self._steps(range(iters)):
            x, changed = self.step(x)
            self.iters_run += 1
            with span("hisparse.sync"):
                done = not bool(changed)
            if done:
                break
        return x[self.inv_t]


def sssp_reference(adj: CSRMatrix, source: int) -> np.ndarray:
    import scipy.sparse.csgraph as csgraph
    return csgraph.dijkstra(adj.to_scipy(), indices=source)


class BFS(_App):
    """Breadth-first search by frontier iteration over max_times on 0/1
    weights (boolean or-and): reached' = reached | (A^T and frontier)."""

    def __init__(self, adj: CSRMatrix, config: SpmvConfig | None = None,
                 device="cuda"):
        cfg = dataclasses.replace(config or SpmvConfig(), semiring="max_times",
                                  dtype="fp32", steal_mantissa=False)
        at = csr_to_csc(adj)
        at = CSRMatrix(at.num_rows, at.num_cols,
                       np.ones(at.nnz, np.float32), at.indices, at.indptr)
        super().__init__(at, cfg, device)

    def step(self, frontier: torch.Tensor, reached: torch.Tensor):
        """One frontier step in rank layout: ``(newly, reached)``, newly
        the 0/1 new frontier."""
        y = (self.spmv(frontier) > 0).float()
        return (y - reached).clamp_min(0.0), torch.maximum(reached, y)

    def run(self, source: int, max_iters: int | None = None,
            masked: bool = False) -> torch.Tensor:
        """BFS level of each node (-1 = unreachable), int64 on the device.

        ``masked=True`` streams only the tiles the current frontier can
        touch (``tiles_streamed`` lists how many): on high-diameter graphs
        early frontiers are small and most of the matrix is never read."""
        max_iters = max_iters if max_iters is not None else self.n
        dev = self.op.device
        src = int(self.inv[source])
        frontier = torch.zeros(self.n_slots, device=dev)
        frontier[src] = 1.0
        reached = frontier.clone()
        level = torch.full((self.n_slots,), -1, dtype=torch.int64, device=dev)
        level[src] = 0
        self.tiles_streamed = []
        act = np.array([src])
        for it in self._steps(range(1, max_iters + 1)):
            if masked:
                if len(act) == 0:
                    break
                y, n_tiles = self.spmv_masked(frontier, act)
                self.tiles_streamed.append(n_tiles)
                y = (y > 0).float()
                newly = (y - reached).clamp_min(0.0)
                reached = torch.maximum(reached, y)
            else:
                newly, reached = self.step(frontier, reached)
            with span("hisparse.sync"):
                ids = torch.nonzero(newly > 0).squeeze(1)
                if masked and len(ids):
                    act = ids[ids < self.n].cpu().numpy()
            if len(ids) == 0:
                break
            level[ids] = it
            frontier = newly
        return level[self.inv_t]
