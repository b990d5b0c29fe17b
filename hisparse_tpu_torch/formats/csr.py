"""CSR containers, .npz IO and synthetic generators — the L4 data layer.

Mirrors the reference's ``sw/data_loader.h``:
  * ``CSRMatrix<T>`` struct (:18-28) -> :class:`CSRMatrix`
  * ``load_csr_matrix_from_float_npz`` (:31-74) -> :func:`load_npz`
    (same npz key convention: shape, data, indices, indptr)
  * ``csr_matrix_convert_from_float`` (:76-84) -> :meth:`CSRMatrix.astype`
  * ``csr2csc`` counting-sort transpose (:92-157) -> :func:`csr_to_csc`
and ``sw/data_formatter.h``:
  * ``util_round_csr_matrix_dim`` (:14-29) -> :func:`round_dims`
  * ``util_normalize_csr_matrix_by_outdegree`` (:32-47) -> :func:`normalize_by_outdegree`
  * ``util_reorder_rows_ascending_nnz`` (:337-368) -> :func:`argsort_rows_by_nnz`
plus the test-fixture generators of ``sw/host.cpp``:
  * ``create_dense_CSR`` (:382-403) -> :func:`dense_csr`
  * ``create_uniform_sparse_CSR`` (:406-430) -> :func:`uniform_sparse_csr`
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Plain CSR triple, matching spmv::io::CSRMatrix (data_loader.h:18-28)."""

    num_rows: int
    num_cols: int
    data: np.ndarray      # (nnz,)
    indices: np.ndarray   # (nnz,) int32 column ids
    indptr: np.ndarray    # (num_rows+1,) int64

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def astype(self, dtype) -> "CSRMatrix":
        return CSRMatrix(self.num_rows, self.num_cols,
                         self.data.astype(dtype), self.indices, self.indptr)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.num_rows, self.num_cols))

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        return CSRMatrix(m.shape[0], m.shape[1],
                         np.asarray(m.data),
                         np.asarray(m.indices, np.int32),
                         np.asarray(m.indptr, np.int64))

    def dense(self) -> np.ndarray:
        out = np.zeros((self.num_rows, self.num_cols), self.data.dtype)
        rows = np.repeat(np.arange(self.num_rows), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out


def load_npz(path) -> CSRMatrix:
    """Load a scipy-convention npz: keys shape, data, indices, indptr.

    Same convention as the reference loader (data_loader.h:31-74), which
    reads the scipy-saved npz produced by the dataset download scripts.
    Also accepts scipy.sparse.save_npz files (format/data/indices/indptr).
    """
    with np.load(path, allow_pickle=False) as f:
        keys = set(f.files)
        if {"shape", "data", "indices", "indptr"} <= keys:
            shape = f["shape"]
            return CSRMatrix(int(shape[0]), int(shape[1]),
                             np.asarray(f["data"]),
                             np.asarray(f["indices"], np.int32),
                             np.asarray(f["indptr"], np.int64))
    import scipy.sparse as sp
    return CSRMatrix.from_scipy(sp.load_npz(path))


def save_npz(path, m: CSRMatrix) -> None:
    np.savez(path, shape=np.array([m.num_rows, m.num_cols]),
             data=m.data, indices=m.indices, indptr=m.indptr)


def round_dims(m: CSRMatrix, row_multiple: int, col_multiple: int) -> CSRMatrix:
    """Pad dims up to multiples (util_round_csr_matrix_dim, data_formatter.h:14-29).

    The reference rounds rows to PACK_SIZE*NUM_CH (=128) and cols to
    PACK_SIZE; we round rows to the row-block and cols to the lane count.
    """
    nr = -(-m.num_rows // row_multiple) * row_multiple
    nc = -(-m.num_cols // col_multiple) * col_multiple
    if nr == m.num_rows and nc == m.num_cols:
        return m
    indptr = np.concatenate([m.indptr,
                             np.full(nr - m.num_rows, m.indptr[-1], m.indptr.dtype)])
    return CSRMatrix(nr, nc, m.data, m.indices, indptr)


def normalize_by_outdegree(m: CSRMatrix) -> CSRMatrix:
    """A[i,j] = 1/outdegree(j) (util_normalize_csr_matrix_by_outdegree,
    data_formatter.h:32-47).  PageRank-style column normalization."""
    outdeg = np.zeros(m.num_cols, np.int64)
    np.add.at(outdeg, m.indices, 1)
    safe = np.where(outdeg == 0, 1, outdeg)
    data = (1.0 / safe[m.indices]).astype(m.data.dtype)
    return CSRMatrix(m.num_rows, m.num_cols, data, m.indices, m.indptr)


def argsort_rows_by_nnz(m: CSRMatrix, descending: bool = False) -> np.ndarray:
    """Row order sorted by nnz (util_reorder_rows_ascending_nnz,
    data_formatter.h:337-368).  Used by the packer for load balance."""
    key = m.row_nnz()
    order = np.argsort(-key if descending else key, kind="stable")
    return order.astype(np.int64)


def argsort_cols_by_degree(m: CSRMatrix) -> np.ndarray:
    """Column order by in-degree descending.  Used as a pack-time
    ``col_order``: hot (hub) columns land in the first vector-buffer blocks,
    concentrating gather traffic into few classes so the block-major
    scheduler's per-group class choices cover most pending items (measured
    +60% schedule fill on power-law graphs, scratch/fill_probe.py)."""
    deg = np.zeros(m.num_cols, np.int64)
    np.add.at(deg, m.indices, 1)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def permute_rows(m: CSRMatrix, order: np.ndarray) -> CSRMatrix:
    """Return m with rows permuted so new row i = old row order[i]."""
    counts = m.row_nnz()[order]
    indptr = np.zeros(m.num_rows + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    # vectorized slice gather: position p of new row i reads
    # old position indptr_old[order[i]] + (p - indptr_new[i])
    pos = (np.arange(m.nnz, dtype=np.int64)
           - np.repeat(indptr[:-1], counts)
           + np.repeat(m.indptr[order], counts))
    return CSRMatrix(m.num_rows, m.num_cols, m.data[pos], m.indices[pos],
                     indptr)


def split_rows(m: CSRMatrix, max_nnz: int) -> tuple["CSRMatrix", np.ndarray]:
    """Split rows with more than max_nnz nonzeros into virtual rows.

    The TPU analog of the reference's row-interleaving for hub rows: bounds
    the per-row wave demand so power-law skew cannot dominate tile count
    (the alpha/beta degradation discussed for max-padded channel streams,
    sw/host.cpp:184-206).  Returns (matrix with virtual rows, row_map) where
    row_map[v] is the original row of virtual row v; y = segment-sum of the
    virtual results by row_map.
    """
    nnz_per = m.row_nnz()
    pieces = np.maximum(1, -(-nnz_per // max_nnz))
    if (pieces == 1).all():
        return m, np.arange(m.num_rows, dtype=np.int64)
    row_map = np.repeat(np.arange(m.num_rows), pieces)
    n_virtual = int(pieces.sum())
    # virtual row v = piece p of original row r ends at
    # min(indptr[r] + (p+1)*max_nnz, indptr[r+1]) — all vectorized
    piece_starts = np.zeros(m.num_rows + 1, np.int64)
    np.cumsum(pieces, out=piece_starts[1:])
    p_idx = np.arange(n_virtual, dtype=np.int64) - piece_starts[row_map]
    ends = np.minimum(m.indptr[row_map] + (p_idx + 1) * max_nnz,
                      m.indptr[row_map + 1])
    indptr = np.concatenate([[0], ends])
    return (CSRMatrix(n_virtual, m.num_cols, m.data, m.indices, indptr),
            row_map)


def csr_to_csc(m: CSRMatrix) -> CSRMatrix:
    """Counting-sort transpose (csr2csc, data_loader.h:92-157).

    Returns the transpose as a CSRMatrix over the transposed shape (i.e. a
    CSC view of m with the same numerics).
    """
    t = m.to_scipy().tocsc()
    return CSRMatrix(m.num_cols, m.num_rows, np.asarray(t.data),
                     np.asarray(t.indices, np.int32),
                     np.asarray(t.indptr, np.int64))


# ----------------------------------------------------------------------------
# Synthetic generators (test fixtures), ports of sw/host.cpp:382-430.
# ----------------------------------------------------------------------------

def dense_csr(num_rows: int, num_cols: int, val=1.0, dtype=np.float32) -> CSRMatrix:
    """Fully dense matrix in CSR form (create_dense_CSR, sw/host.cpp:382-403)."""
    data = np.full(num_rows * num_cols, val, dtype)
    indices = np.tile(np.arange(num_cols, dtype=np.int32), num_rows)
    indptr = np.arange(num_rows + 1, dtype=np.int64) * num_cols
    return CSRMatrix(num_rows, num_cols, data, indices, indptr)


def uniform_sparse_csr(num_rows: int, num_cols: int, nnz_per_row: int,
                       seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """Uniform row-regular random matrix (create_uniform_sparse_CSR,
    sw/host.cpp:406-430): every row has exactly nnz_per_row nonzeros at
    uniform-random distinct columns; values U(0,1).

    Vectorized rejection sampling: draw all rows at once, re-draw colliding
    slots until every row's columns are distinct (expected O(log) rounds
    even at 10% density).  Rejection stalls as density approaches 1, so
    rows denser than half the columns fall back to per-row permutations."""
    assert nnz_per_row <= num_cols
    rng = np.random.default_rng(seed)
    if nnz_per_row > num_cols // 2:
        cols = np.stack([rng.permutation(num_cols)[:nnz_per_row]
                         for _ in range(num_rows)])
        cols.sort(axis=1)
        data = rng.random(num_rows * nnz_per_row, np.float32).astype(dtype)
        indptr = np.arange(num_rows + 1, dtype=np.int64) * nnz_per_row
        return CSRMatrix(num_rows, num_cols, data,
                         cols.reshape(-1).astype(np.int32), indptr)
    cols = rng.integers(0, num_cols, (num_rows, nnz_per_row), dtype=np.int64)
    while True:
        cols.sort(axis=1)
        dup_r, dup_c = np.nonzero(cols[:, 1:] == cols[:, :-1])
        if dup_r.size == 0:
            break
        cols[dup_r, dup_c + 1] = rng.integers(0, num_cols, dup_r.size)
    data = rng.random(num_rows * nnz_per_row, np.float32).astype(dtype)
    indptr = np.arange(num_rows + 1, dtype=np.int64) * nnz_per_row
    return CSRMatrix(num_rows, num_cols, data,
                     cols.reshape(-1).astype(np.int32), indptr)


def rmat_csr(num_rows: int, num_cols: int, avg_nnz_per_row: float,
             a: float = 0.57, b: float = 0.19, c: float = 0.19,
             seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """R-MAT (Kronecker) random graph — the standard synthetic for social
    networks (Graph500 uses a=0.57,b=c=0.19): power-law degrees AND edge
    locality, unlike uniformly-random columns which are a locality-free
    worst case no real graph exhibits.  Stand-in for the pokec/hollywood
    class of the reference's suite (sw/bm.sh)."""
    rng = np.random.default_rng(seed)
    n = max(num_rows, num_cols)
    scale = max(1, int(np.ceil(np.log2(n))))
    # modest oversampling covers edges falling outside the
    # (num_rows, num_cols) corner of the Kronecker square (RMAT mass
    # concentrates at low indices, so the keep fraction is high); the
    # surviving set is trimmed to the exact edge target
    target = int(num_rows * avg_nnz_per_row)
    n_edges = int(target * 1.4)
    rows = np.zeros(n_edges, np.int64)
    cols = np.zeros(n_edges, np.int64)
    for lvl in range(scale):
        u = rng.random(n_edges)
        # quadrant probabilities (a | b / c | d) per Kronecker level
        down = (u >= a + b)                       # c + d quadrants
        right_q = ((u >= a) & (u < a + b)) | (u >= a + b + c)
        rows = (rows << 1) | down
        cols = (cols << 1) | right_q
    keep = (rows < num_rows) & (cols < num_cols)
    rows, cols = rows[keep][:target], cols[keep][:target]
    import scipy.sparse as sp
    coo = sp.coo_matrix((rng.random(rows.size).astype(dtype), (rows, cols)),
                        shape=(num_rows, num_cols))
    coo.sum_duplicates()
    return CSRMatrix.from_scipy(coo.tocsr())


def block_structured_csr(num_rows: int, num_cols: int, block_rows: int = 16,
                         block: int = 128, density_in_block: float = 0.9,
                         seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """Block-sparse fixture: each (block x block) block-row has
    ``block_rows`` randomly placed dense-ish blocks (the BCSR/SpMM batch
    regime of BASELINE.json — pruned-NN structured sparsity)."""
    rng = np.random.default_rng(seed)
    nbr, nbc = num_rows // block, num_cols // block
    bcols = np.stack([rng.choice(nbc, min(block_rows, nbc), replace=False)
                      for _ in range(nbr)])
    nb = bcols.size
    per_block = int(block * block * density_in_block)
    br = np.repeat(np.arange(nbr), bcols.shape[1])
    r_in = rng.integers(0, block, (nb, per_block))
    c_in = rng.integers(0, block, (nb, per_block))
    rows = (br[:, None] * block + r_in).reshape(-1)
    cols = (bcols.reshape(-1)[:, None] * block + c_in).reshape(-1)
    import scipy.sparse as sp
    coo = sp.coo_matrix((rng.random(rows.size).astype(dtype), (rows, cols)),
                        shape=(num_rows, num_cols))
    coo.sum_duplicates()
    return CSRMatrix.from_scipy(coo.tocsr())


def powerlaw_csr(num_rows: int, num_cols: int, avg_nnz_per_row: float,
                 alpha: float = 1.5, seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """Power-law row-degree matrix approximating graph adjacency skew
    (the gplus/pokec regime of the reference's dataset suite, bm.sh:4-17)."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, num_rows) + 1.0
    deg = np.minimum((raw * avg_nnz_per_row / raw.mean()).astype(np.int64), num_cols)
    indptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, num_cols, nnz).astype(np.int32)
    # sort within rows (duplicates allowed; SpMV sums) — vectorized
    rows = np.repeat(np.arange(num_rows), deg)
    order = np.lexsort((indices, rows))
    indices = indices[order]
    data = rng.random(nnz, np.float32).astype(dtype)
    return CSRMatrix(num_rows, num_cols, data, indices, indptr)
