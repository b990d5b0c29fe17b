"""Dense and block-dense paths, the moderate-sparsity regime: the port of
``hisparse_tpu/ops/dense.py``.

The reference's pruned-NN suite (transformer_{50..95}, 5-50% density,
bm.sh:10-17) is near the density where a dense representation wins on a
machine with a strong matmul unit: at 50% density a dense bf16 row costs
4 bytes per true nonzero against the sparse stream's 8, and the tensor
cores do the multiply for free.  So the format is a choice:

  * :class:`DenseOperator`: y = A @ x with A stored dense (fp32, or bf16
    with fp32 accumulation), row-padded to 8 and column-padded to 128.
  * :class:`SpmmOperator`: multi-vector Y = A @ X (X with k columns, the
    BCSR/SpMM batch config of BASELINE.json), same storage.
  * :func:`choose_format`: dispatch between wavepack, BCSR and dense (the
    DSE answers within-format geometry; this answers which format).

Both operators are plain matrix products (``dense_mm``), as the JAX
package leaves them to XLA: no hand kernel.  GOPS here still counts
2*nnz(A_sparse)/t like the reference (benchmark.cpp:314).
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.csr import CSRMatrix


def _round_up(v, m):
    return -(-v // m) * m


def dense_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result.  A bf16 product keeps bf16 inputs
    and a float32 output, as the JAX ``jnp.dot(...,
    preferred_element_type=float32)``: on CUDA ``torch.mm(a, b,
    out_dtype=torch.float32)`` (a plain bf16 ``mm`` would round y to bf16),
    on the CPU, where that overload does not exist, both operands upcast
    (a product of two bf16 values is exact in float32)."""
    if a.dtype == torch.bfloat16:
        if a.device.type == "cuda":
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.to(torch.float32), b.to(torch.float32))
    return torch.mm(a, b)


class DenseOperator(torch.nn.Module):
    """y = A @ x from a CSR input densified when the operator is built, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, m: CSRMatrix, dtype: str = "bf16", device="cuda"):
        super().__init__()
        self.num_rows, self.num_cols = m.num_rows, m.num_cols
        self.nnz = m.nnz
        rows = _round_up(max(m.num_rows, 1), 8)
        cols = _round_up(max(m.num_cols, 1), 128)
        dense = np.zeros((rows, cols), np.float32)
        r = np.repeat(np.arange(m.num_rows), m.row_nnz())
        dense[r, m.indices] = m.data
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        self.register_buffer(
            "a", torch.from_numpy(dense).to(tdt).to(torch.device(device)))
        self.dtype = dtype
        self.stream_bytes = self.a.numel() * self.a.element_size()

    def padded(self, X) -> torch.Tensor:
        """x (num_cols,) or X (num_cols, k) -> (cols, k) in A's dtype,
        zero-padded to A's columns."""
        X = torch.as_tensor(X, device=self.a.device).to(self.a.dtype)
        X = X.reshape(X.shape[0], -1)
        return torch.nn.functional.pad(
            X, (0, 0, 0, self.a.shape[1] - X.shape[0]))

    def forward(self, x, renamed: bool = False) -> torch.Tensor:
        del renamed  # no renaming in the dense path
        return dense_mm(self.a, self.padded(x))[:self.num_rows, 0]


class SpmmOperator(torch.nn.Module):
    """Multi-vector Y = A @ X (k right-hand sides), the dense batch path
    (BASELINE.json config: x with 64 cols)."""

    def __init__(self, m: CSRMatrix, dtype: str = "bf16", device="cuda"):
        super().__init__()
        self.inner = DenseOperator(m, dtype, device)
        self.nnz = m.nnz

    def forward(self, X) -> torch.Tensor:
        return dense_mm(self.inner.a,
                        self.inner.padded(X))[:self.inner.num_rows]


# wavepack prior for the cheap bound: a typical fill, over the card's
# measured stream rate (rates_h100.json "wavepack_gbps"); only used to
# decide whether the decision is close enough to warrant a real sampled
# pack (see choose_format)
_WAVE_FILL_PRIOR = 0.5


def wavepack_time_per_nnz(m: CSRMatrix, sample_rows_max: int = 8192,
                          rates: dict | None = None) -> float:
    """Model-calibrated wavepack cost in ns/nnz: pack a row sample at the
    regime-default design points and take the perf model's best time/nnz
    (models/perf_model.estimate_pack, fed with the real fill/alpha of the
    sampled pack and the card's slot-rate tables, the analog of the
    reference's instrumented-csim cost, performance_model.cpp:430-444).

    Row samples overestimate fill slightly (fewer distinct columns per
    bank), so this bound is mildly optimistic for wavepack, acceptable for
    format dispatch where the dense and bcsr arms are exact byte counts."""
    from ..config import SpmvConfig
    from ..formats.wavepack import pack
    from ..models.dse import sample_rows
    from ..models.perf_model import estimate_pack

    ms = sample_rows(m, sample_rows_max)
    avg = ms.nnz / max(ms.num_rows, 1)
    cands = [
        # dense-rows regime point (bench.py density>=0.05 default)
        (SpmvConfig(sublanes=512, bank_blocks=2, stripes=4,
                    two_choice=True), "auto"),
    ]
    bm = SpmvConfig(sublanes=512, bank_blocks=8, stripes=128,
                    two_choice=False, block_major=True, classes_per_group=2,
                    steal_mantissa=True)
    if ms.num_rows >= bm.rows_per_block // 8:
        split = max(8, (1 << int(round(np.log2(max(avg, 1.0))))) // 2)
        cands.append((bm, split))
    best = np.inf
    for cfg, split in cands:
        wp = pack(ms, cfg, split_max=split, col_order="degree")
        est = estimate_pack(wp, rates=rates)
        best = min(best, est.time_s / max(wp.nnz, 1) * 1e9)
    return best


# choose_format counts a matrix's nonempty (128, 128) blocks exactly when
# its block grid has at most this many cells (a bool bitmap of 16 MB):
# bcsr-spmm-16k's 128 x 128 and googleplus's 844 x 844 grids among them;
# the sampled estimate serves larger grids
BLOCK_BITMAP_CELLS = 1 << 24


def block_count(m: CSRMatrix, sample_nnz: int = 4_000_000) -> int:
    """The nonempty (128, 128) blocks of ``m`` (choose_format's block-fill
    heuristic): exact (:func:`block_count_exact`) when the block grid has
    at most ``BLOCK_BITMAP_CELLS`` cells, else the JAX package's estimate
    (:func:`block_count_sampled`).  The port counts exactly where the JAX
    package samples: on bcsr-spmm-16k the sample's coupon-collector
    scaling gave 8,390 blocks for 3,072 and sent the matrix to the slower
    dense arm."""
    nbr = -(-m.num_rows // 128)
    nbc = -(-m.num_cols // 128)
    if nbr * nbc <= BLOCK_BITMAP_CELLS:
        return block_count_exact(m)
    return block_count_sampled(m, sample_nnz)


def block_count_exact(m: CSRMatrix, chunk: int = 1 << 22) -> int:
    """The nonempty (128, 128) blocks of ``m``, exactly: every nonzero
    marks its block in a bitmap of the block grid, ``chunk`` nonzeros at
    a time."""
    nbr = -(-m.num_rows // 128)
    nbc = -(-m.num_cols // 128)
    seen = np.zeros((nbr, nbc), bool)
    # the first nonzero of each block row
    starts = np.asarray(m.indptr)[np.minimum(np.arange(nbr + 1) * 128,
                                             m.num_rows)]
    for c0 in range(0, m.nnz, chunk):
        pos = np.arange(c0, min(m.nnz, c0 + chunk))
        br = np.searchsorted(starts, pos, side="right") - 1
        seen[br, m.indices[pos] // 128] = True
    return int(np.count_nonzero(seen))


def block_count_sampled(m: CSRMatrix, sample_nnz: int = 4_000_000) -> int:
    """The JAX package's count (hisparse_tpu/ops/dense.py, choose_format):
    exact up to ``sample_nnz`` nonzeros, above that estimated from
    ``sample_nnz`` evenly spaced nonzeros, scaled by a coupon-collector
    correction."""
    nbc = -(-m.num_cols // 128)
    if m.nnz <= sample_nnz:
        rows = np.repeat(np.arange(m.num_rows), m.row_nnz())
        key = (rows // 128).astype(np.int64) * nbc + m.indices // 128
        return int(np.unique(key).size)
    take = np.linspace(0, m.nnz - 1, sample_nnz).astype(np.int64)
    rows = np.searchsorted(m.indptr, take, side="right") - 1
    key = (rows // 128).astype(np.int64) * nbc + m.indices[take] // 128
    # sampled distinct-block count underestimates; scale by the
    # coupon-collector correction for a uniform fallback
    nb_s = np.unique(key).size
    return int(nb_s * max(1.0, m.nnz / sample_nnz) ** 0.5)


def format_times(m: CSRMatrix, sample_nnz: int = 4_000_000,
                 calibrate: bool = True,
                 rates: dict | None = None) -> dict:
    """choose_format's estimates, in ns per nonzero, by format."""
    from ..models.perf_model import card_rates
    rates = card_rates() if rates is None else rates
    density = m.nnz / max(m.num_rows * m.num_cols, 1)
    nb = block_count(m, sample_nnz)
    t_dense = (2.0 / max(density, 1e-12)) / rates["dense_bf16_gbps"]
    t_bcsr = (2.0 * 128 * 128 * nb / m.nnz) / rates["bcsr_bf16_gbps"]
    t_wave = (8.0 / _WAVE_FILL_PRIOR) / rates["wavepack_gbps"]
    t_alt = min(t_dense, t_bcsr)
    if calibrate and t_alt / 2.5 < t_wave < t_alt * 2.5:
        t_wave = wavepack_time_per_nnz(m, rates=rates)
    return {"wavepack": t_wave, "bcsr": t_bcsr, "dense": t_dense}


def choose_format(m: CSRMatrix, sample_nnz: int = 4_000_000,
                  calibrate: bool = True, rates: dict | None = None) -> str:
    """Three-way format dispatch: 'wavepack' | 'bcsr' | 'dense'.

    Compares estimated device time per nonzero (ns/nnz).  The dense and
    bcsr arms are exact byte counts over the card's measured stream rates
    (``rates_h100.json``, ``models/perf_model.card_rates``):

      dense     2 B/cell bf16 / density             @ dense_bf16_gbps
      bcsr      32 KB per nonempty (128,128) block / nnz  @ bcsr_bf16_gbps

    The wavepack arm starts from a cheap prior (8 B/slot at fill 0.5 over
    ``wavepack_gbps``, the SpMV kernel's measured stream rate) and, when
    the prior lands within 2.5x of the best alternative, where the prior's
    fixed fill constant can misroute, is re-evaluated by the analytical
    perf model on a real sampled pack (wavepack_time_per_nnz), so the
    crossover tracks the matrix's actual fill/alpha and the card's slot
    rates.

    The nonempty-block count is :func:`block_count`: exact wherever the
    block grid fits ``BLOCK_BITMAP_CELLS``, the JAX package's sampled
    estimate above that.  Without the rates file this raises
    (``FileNotFoundError``): the dispatch has no fallback."""
    if m.nnz == 0:
        return "wavepack"
    t = format_times(m, sample_nnz, calibrate, rates)
    return min(("wavepack", "bcsr", "dense"), key=lambda k: t[k])
