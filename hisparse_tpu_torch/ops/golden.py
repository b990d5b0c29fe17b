"""CPU golden models — the analog of the reference's compute_ref + csim math.

A copy of ``hisparse_tpu/ops/golden.py`` (numpy only), so the port checks
itself against the same oracles without importing the JAX package.

The reference validates every run against a CPU float reference
(``compute_ref``, sw/host.cpp:33-48, tolerance 1e-4 at sw/host.cpp:62) and,
for the fixed-point bitstream, against the same arithmetic done in
ap_ufixed on the host.  Here:

  * :func:`spmv_f64` / :func:`spmv_f32` — float references.
  * :func:`spmv_fixed` — bit-exact saturating unsigned Q8.24, reproducing
    ``VAL_T = ap_ufixed<32,8,AP_RND,AP_SAT>`` (spmv/libfpga/common.h:35-39):
    32-bit unsigned value with 8 integer bits; multiplication rounds the
    48-bit fractional product to 24 bits with AP_RND (round-half-up) and
    saturates with AP_SAT; accumulation saturates at the type maximum.
"""
from __future__ import annotations

import numpy as np

from ..formats.csr import CSRMatrix

FIX_FRAC_BITS = 24
FIX_MAX = np.uint64(0xFFFFFFFF)  # ap_ufixed<32,8> all-ones


def spmv_f64(m: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Double-precision reference (the strictest oracle)."""
    y = np.zeros(m.num_rows, np.float64)
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
    np.add.at(y, rows, m.data.astype(np.float64) * x.astype(np.float64)[m.indices])
    return y


def spmv_f32(m: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Single-precision reference matching compute_ref (sw/host.cpp:33-48):
    float accumulate in CSR order."""
    y = np.zeros(m.num_rows, np.float32)
    for r in range(m.num_rows):
        s, e = m.indptr[r], m.indptr[r + 1]
        y[r] = np.float32(
            np.add.reduce((m.data[s:e] * x[m.indices[s:e]]).astype(np.float32)))
    return y


# ----------------------------------------------------------------------------
# Fixed point Q8.24 (ap_ufixed<32,8,AP_RND,AP_SAT>)
# ----------------------------------------------------------------------------

def float_to_fixed(v: np.ndarray) -> np.ndarray:
    """Quantize float -> raw uint32 Q8.24 with AP_RND/AP_SAT semantics.

    Matches the reference host conversion path (data_loader.h:76-84 assigns
    float to VAL_T, i.e. ap_ufixed rounding): round-half-up to 24 frac bits,
    clamp to [0, 256).
    """
    scaled = np.floor(np.asarray(v, np.float64) * (1 << FIX_FRAC_BITS) + 0.5)
    scaled = np.clip(scaled, 0, float(FIX_MAX))
    return scaled.astype(np.uint64).astype(np.uint32)


def fixed_to_float(raw: np.ndarray) -> np.ndarray:
    return raw.astype(np.float64) / (1 << FIX_FRAC_BITS)


def fixed_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Q8.24 * Q8.24 -> Q8.24 with AP_RND + AP_SAT (pe.h:62: q + mat*vec is
    computed on VAL_T operands; HLS evaluates the product in ap_ufixed<64,16>
    then rounds/saturates on assignment)."""
    p = a.astype(np.uint64) * b.astype(np.uint64)        # Q16.48
    p = p + (np.uint64(1) << np.uint64(FIX_FRAC_BITS - 1))  # AP_RND half-up
    p >>= np.uint64(FIX_FRAC_BITS)                        # -> Q.24 scale
    return np.minimum(p, FIX_MAX).astype(np.uint32)       # AP_SAT


def fixed_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Saturating unsigned add (AP_SAT on the accumulator, pe.h:66-71)."""
    s = a.astype(np.uint64) + b.astype(np.uint64)
    return np.minimum(s, FIX_MAX).astype(np.uint32)


def spmv_fixed(m: CSRMatrix, x_raw: np.ndarray, data_raw: np.ndarray | None = None,
               ) -> np.ndarray:
    """Bit-exact fixed-point SpMV.  data_raw/x_raw are uint32 Q8.24.

    Accumulation order note: saturating SIGNED addition is not associative,
    but this type is UNSIGNED (ap_ufixed), and for nonnegative terms the
    per-step AP_SAT fold is order-independent: by induction,
    ``acc_k = min(acc_{k-1} + t_k, MAX) = min(prefix_sum_k, MAX)`` (once the
    prefix crosses MAX the accumulator pins at MAX and stays there), so ANY
    accumulation order — CSR order here, wave order + stripe fold in the
    kernel, uint64-sum-then-clamp in ``Wavepack.unpack_y``'s hub recombine —
    yields exactly ``min(sum of rounded products, MAX)``, even with multiple
    saturation events per row (tests/test_fixed.py multi-saturation cases).
    Like the reference csim we still accumulate in CSR order for
    readability.
    """
    if data_raw is None:
        data_raw = float_to_fixed(m.data)
    y = np.zeros(m.num_rows, np.uint32)
    for r in range(m.num_rows):
        acc = np.uint32(0)
        for k in range(m.indptr[r], m.indptr[r + 1]):
            acc = fixed_add(acc, fixed_mul(data_raw[k], x_raw[m.indices[k]]))
        y[r] = acc
    return y


def spmv_fixed_vec(m: CSRMatrix, x_raw: np.ndarray,
                   data_raw: np.ndarray | None = None) -> np.ndarray:
    """Vectorized bit-exact fixed SpMV for the saturation-free case.

    When neither any rounded product nor any row sum exceeds the Q8.24
    range, saturating accumulation equals plain modular accumulation and is
    order-independent, so one vectorized pass matches :func:`spmv_fixed`
    exactly; otherwise falls back to the sequential reference."""
    if data_raw is None:
        data_raw = float_to_fixed(m.data)
    prod = data_raw.astype(np.uint64) * x_raw[m.indices].astype(np.uint64)
    prod = (prod + (np.uint64(1) << np.uint64(FIX_FRAC_BITS - 1))) \
        >> np.uint64(FIX_FRAC_BITS)
    if prod.size and int(prod.max()) > int(FIX_MAX):
        return spmv_fixed(m, x_raw, data_raw)
    acc = np.zeros(m.num_rows, np.uint64)
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
    np.add.at(acc, rows, prod)
    if acc.size and int(acc.max()) > int(FIX_MAX):
        return spmv_fixed(m, x_raw, data_raw)
    return acc.astype(np.uint32)
