"""The work a request asks of the card, counted from the CSR matrix alone,
and the least time the card could take for it.

Whatever format the program streams, the work is that of the CSR product:
each nonzero's value and column index read once (4 B + 4 B), the row
pointer once ((rows + 1) * 4 B), x read once (cols * F * 4 B) and y written
once (rows * F * 4 B); 2 operations a nonzero and feature (a multiply and
an add, or an add and a min).  A pack's padding slots, its split rows and
the fold of their partials are the program's overhead, not work.
"""
from __future__ import annotations

# the data sheet of each card the benchmark knows, by
# torch.cuda.get_device_name(): HBM bytes a second and fp32 operations a
# second outside the tensor cores (NVIDIA H100 SXM5 80 GB data sheet, at
# its 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3350e9,
                              "fp32_ops_per_s": 67e12},
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no data-sheet peaks on record for {kind!r}")
    return PEAKS[kind]


def csr_bytes(num_rows: int, num_cols: int, nnz: int,
              features: int = 1) -> int:
    return (nnz * (4 + 4) + (num_rows + 1) * 4 + num_cols * features * 4
            + num_rows * features * 4)


def csr_ops(nnz: int, features: int = 1) -> int:
    return 2 * nnz * features


def bound_s(num_rows: int, num_cols: int, nnz: int, features: int,
            peak: dict) -> float:
    """The least seconds one product takes on the card: the larger of its
    bytes at the HBM rate and its operations at the fp32 rate."""
    return max(csr_bytes(num_rows, num_cols, nnz, features)
               / peak["hbm_bytes_per_s"],
               csr_ops(nnz, features) / peak["fp32_ops_per_s"])
