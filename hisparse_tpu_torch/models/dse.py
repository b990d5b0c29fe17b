"""Design-space explorer, the port of ``hisparse_tpu/models/dse.py``
(itself the port of performance_model/design_space_exp.cpp).

The reference sweeps (vector-buffer, output-buffer) bank sizes under a URAM
budget (design_space_exp.cpp:505-520) and picks the geomean-best point over
its dataset suite (:524-547, emitting a CSV).

Here the knobs are (sublanes S, bank_blocks B, stripes R, split_max), the
cost function is the analytical model (models/perf_model.py, on the card's
measured rates) fed with real pack statistics, and the result is the
geomean-best SpmvConfig over a workload list plus a CSV dump.  The grid is
the JAX package's; the TPU's VMEM budget does not carry over (the kernel
reads XT through L2 and keeps no resident accumulator), so no point is
filtered by it.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import numpy as np

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix
from ..formats.wavepack import pack
from ..utils.bench import geomean
from .perf_model import HBM_GBPS, estimate


@dataclasses.dataclass
class DsePoint:
    cfg: SpmvConfig
    split_max: int | None
    gops_geomean: float
    per_matrix: list


def default_grid():
    pts = []
    for S, B, R, tc, split in itertools.product(
            (256, 512), (1, 2, 4, 8), (4, 64, 256, 512),
            (False, True), (None, "auto")):
        if R > S:
            continue
        try:
            cfg = SpmvConfig(sublanes=S, bank_blocks=B, stripes=R,
                             two_choice=tc)
        except ValueError:
            continue
        pts.append((cfg, split))
    # the block-major family (class-group scheduling); steal_mantissa rides
    # the values so the kernel reads the crossbar lane without an idx field
    for B, K, tc in ((4, 2, True), (8, 2, False), (8, 4, False),
                     (16, 4, True), (8, 1, True)):
        for R in (128, 512):
            pts.append((SpmvConfig(sublanes=512, bank_blocks=B, stripes=R,
                                   two_choice=tc, block_major=True,
                                   classes_per_group=K,
                                   steal_mantissa=True), "auto"))
    return pts


def sample_rows(m: CSRMatrix, max_rows: int, seed: int = 0,
                max_nnz: int = 1_500_000) -> CSRMatrix:
    """Row-sampled surrogate so a sweep over many points stays cheap (the
    model only needs representative fill/alpha statistics).  Bounded by both
    a row cap and an nnz cap (dense-row matrices hit the latter first).
    The same rows as the JAX package's ``sample_rows`` for the same
    seed."""
    avg = m.nnz / max(m.num_rows, 1)
    max_rows = min(max_rows, max(128, int(max_nnz / max(avg, 1e-9))))
    if m.num_rows <= max_rows:
        return m
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(m.num_rows, max_rows, replace=False))
    counts = m.row_nnz()[rows]
    indptr = np.zeros(max_rows + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    pos = (np.arange(int(indptr[-1]), dtype=np.int64)
           - np.repeat(indptr[:-1], counts)
           + np.repeat(m.indptr[rows], counts))
    return CSRMatrix(max_rows, m.num_cols, m.data[pos], m.indices[pos],
                     indptr)


def explore(matrices: Sequence[tuple[str, CSRMatrix]],
            grid=None, hbm_gbps: float = HBM_GBPS,
            sample_max_rows: int = 200_000,
            csv_path: str | None = None,
            col_order=None,
            verbose: bool = False,
            rates: dict | None = None) -> list[DsePoint]:
    """Evaluate every design point on every matrix; returns points sorted
    best-first by geomean estimated GOPS."""
    grid = grid if grid is not None else default_grid()
    sampled = [(n, sample_rows(m, sample_max_rows)) for n, m in matrices]
    results = []
    for cfg, split in grid:
        per = []
        skip = False
        for name, m in sampled:
            # block-major needs populated stripes; with far fewer rows than
            # a block the class schedule degenerates (and packs very slowly)
            if cfg.block_major and m.num_rows < cfg.rows_per_block // 8:
                skip = True
                break
            t0 = time.perf_counter()
            wp = pack(m, cfg, split_max=split, col_order=col_order)
            est = estimate(m, cfg, wp, hbm_gbps, rates)
            per.append((name, est, time.perf_counter() - t0))
        if skip:
            continue
        point = DsePoint(cfg, split, geomean([e.gops for _, e, _ in per]),
                         per)
        results.append(point)
        if verbose:
            print(f"S={cfg.sublanes:4d} B={cfg.bank_blocks} "
                  f"R={cfg.stripes:4d} split={split}: "
                  f"{point.gops_geomean:8.1f} GOPS geomean")
    results.sort(key=lambda p: -p.gops_geomean)
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("sublanes,bank_blocks,stripes,split_max,gops_geomean\n")
            for p in results:
                f.write(f"{p.cfg.sublanes},{p.cfg.bank_blocks},"
                        f"{p.cfg.stripes},{p.split_max},"
                        f"{p.gops_geomean:.2f}\n")
    return results


def best_config(m: CSRMatrix, grid=None,
                **kw) -> tuple[SpmvConfig, int | None]:
    """Single-matrix auto-tuner (the per-run bank-size override analog,
    sw/benchmark.cpp:112-115)."""
    pts = explore([("m", m)], grid=grid, **kw)
    return pts[0].cfg, pts[0].split_max
