"""The benchmark's matrix generators, frozen here so that a change to the
program cannot move the yardstick.

They follow the port's ``formats/csr.py`` generators (``powerlaw_csr``:
Pareto row degrees, uniform columns; ``rmat_csr``: Graph500's R-MAT
quadrant recursion), but draw with ``torch.Generator``s on the card, in a
few large calls, so that a 30M-edge graph is made in about a second.  The
numbers therefore differ from numpy's at the same seed; the distributions
do not.  Two changes make a stand-in the size of the graph it stands for:
each generator reaches its ``nnz`` exactly (the port's fall short, by the
degree cap's and the rounding's loss and by R-MAT's duplicates), and
every entry is a distinct edge (the port's ``powerlaw_csr`` keeps a row's
repeated columns as separate entries).

The structure (which entries exist) comes from the configuration's frozen
``structure_seed``, as a real graph is one fixed matrix; the values (edge
weights) and every input come from the run's ``--seed``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Csr:
    """A CSR matrix in host memory: ``indptr`` int64, ``indices`` int32,
    ``data`` float32."""

    num_rows: int
    num_cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)


def subseed(seed: int, salt: str) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed (any
    whole number) and the stream's name."""
    words = [int(seed) % (1 << 64)] + list(salt.encode())
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def generator(seed: int, salt: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, salt))


def _to_host(num_rows, num_cols, rows, cols, data) -> Csr:
    """CSR from entries already sorted by (row, column)."""
    counts = torch.bincount(rows, minlength=num_rows)
    indptr = torch.zeros(num_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Csr(num_rows, num_cols, indptr.cpu().numpy(),
               cols.to(torch.int32).cpu().numpy(), data.cpu().numpy())


def _degrees(weight: torch.Tensor, total: int, cap: int) -> torch.Tensor:
    """Whole row degrees in proportion to ``weight``, each at most ``cap``,
    that sum to ``total`` exactly: the scale at which the capped shares
    sum to the total (bisection), each share rounded down, and the rest
    handed one each to the uncapped rows of largest remainder."""
    if total > cap * weight.numel():
        raise ValueError(f"{total} entries do not fit {weight.numel()} rows "
                         f"of {cap}")
    lo, hi = 0.0, cap / float(weight.min())
    for _ in range(200):
        mid = (lo + hi) / 2
        if float(torch.clamp(weight * mid, max=cap).sum()) < total:
            lo = mid
        else:
            hi = mid
    share = torch.clamp(weight * lo, max=cap)
    deg = share.floor().long()
    rest = total - int(deg.sum())
    frac = torch.where(deg < cap, share - deg, torch.full_like(share, -1.0))
    order = torch.argsort(frac, descending=True, stable=True)
    if rest > int((deg < cap).sum()):
        raise RuntimeError("the degrees cannot reach the total")
    deg[order[:rest]] += 1
    return deg


def _distinct(keys: torch.Tensor) -> torch.Tensor:
    """The positions of the first occurrence of each key, in draw order."""
    sk, order = torch.sort(keys, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return torch.sort(order[first]).values


def _distinct_columns(deg: torch.Tensor, num_cols: int, g,
                      device) -> torch.Tensor:
    """Sorted ``row * num_cols + column`` keys with ``deg[row]`` distinct
    columns in each row, drawn uniformly: a row of more than a quarter of
    the columns takes a prefix of a permutation; the others draw with
    replacement, top up until each holds enough distinct columns, and keep
    a uniform subset of its degree."""
    num_rows = deg.numel()
    rows = torch.arange(num_rows, device=device)
    wide = deg > num_cols // 4
    parts = [r * num_cols + torch.randperm(num_cols, generator=g,
                                           device=device)[:int(deg[r])]
             for r in torch.nonzero(wide).flatten().tolist()]
    need = torch.where(wide, 0, deg)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    short = need
    while int(short.sum()):
        draw = torch.where(short > 0, short + short // 8 + 1, 0)
        r = torch.repeat_interleave(rows, draw)
        c = torch.randint(0, num_cols, (r.numel(),), generator=g,
                          device=device)
        keys = torch.unique(torch.cat([keys, r * num_cols + c]))
        short = torch.clamp(need - torch.bincount(
            keys // num_cols, minlength=num_rows), min=0)
    # a uniform subset of ``need[row]`` of each row's distinct columns
    keys = keys[torch.argsort(torch.rand(keys.numel(), generator=g,
                                         device=device))]
    keys = keys[torch.sort(keys // num_cols, stable=True).indices]
    krow = keys // num_cols
    start = torch.zeros(num_rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(krow, minlength=num_rows), 0,
                 out=start[1:])
    rank = torch.arange(keys.numel(), device=device) - start[krow]
    keys = keys[rank < need[krow]]
    return torch.sort(torch.cat([keys] + parts)).values


def powerlaw(num_rows: int, num_cols: int, nnz: int, alpha: float,
             structure_seed: int, value_seed: int, device) -> Csr:
    """Power-law row degrees (the gplus regime): degree ~ Pareto(alpha) + 1,
    scaled so that the degrees, capped at ``num_cols``, sum to ``nnz``
    exactly; distinct uniform columns in each row; values U(0, 1)."""
    g = generator(structure_seed, "structure", device)
    raw = torch.exp(torch.empty(num_rows, dtype=torch.float64, device=device)
                    .exponential_(generator=g) / alpha)
    key = _distinct_columns(_degrees(raw, int(nnz), num_cols), num_cols, g,
                            device)
    data = torch.rand(key.numel(), generator=generator(
        value_seed, "values", device), device=device)
    return _to_host(num_rows, num_cols, key // num_cols, key % num_cols,
                    data)


def rmat(num_rows: int, num_cols: int, nnz: int, structure_seed: int,
         value_seed: int, device, a: float = 0.57, b: float = 0.19,
         c: float = 0.19) -> Csr:
    """R-MAT (Graph500's a, b, c) with exactly ``nnz`` distinct edges:
    edges drawn in rounds (1.4 times the shortfall, those outside the
    ``num_rows`` x ``num_cols`` corner dropped) until ``nnz`` distinct
    ones are in hand, the first ``nnz`` of them in draw order kept;
    values U(0, 1)."""
    nnz = int(nnz)
    if nnz > num_rows * num_cols:
        raise ValueError(f"{nnz} edges do not fit {num_rows} x {num_cols}")
    g = generator(structure_seed, "structure", device)
    scale = max(1, math.ceil(math.log2(max(num_rows, num_cols))))
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < nnz:
        n_edges = int((nnz - keys.numel()) * 1.4) + 1024
        rows = torch.zeros(n_edges, dtype=torch.int64, device=device)
        cols = torch.zeros_like(rows)
        for _ in range(scale):
            u = torch.rand(n_edges, generator=g, dtype=torch.float64,
                           device=device)
            down = u >= a + b
            right = ((u >= a) & (u < a + b)) | (u >= a + b + c)
            rows = (rows << 1) | down
            cols = (cols << 1) | right
        keep = (rows < num_rows) & (cols < num_cols)
        keys = torch.cat([keys, rows[keep] * num_cols + cols[keep]])
        keys = keys[_distinct(keys)]
    key = torch.sort(keys[:nnz]).values
    data = torch.rand(nnz, generator=generator(value_seed, "values", device),
                      device=device)
    return _to_host(num_rows, num_cols, key // num_cols, key % num_cols,
                    data)


GENERATORS = {"powerlaw": powerlaw, "rmat": rmat}


def make(spec: dict, value_seed: int, device) -> Csr:
    """The matrix of a configuration's ``generator`` entry: ``kind`` names
    the generator, ``structure_seed`` its frozen structure, the other keys
    its size arguments."""
    kw = {k: v for k, v in spec.items() if k != "kind"}
    return GENERATORS[spec["kind"]](value_seed=value_seed, device=device,
                                    **kw)
