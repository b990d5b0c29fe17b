"""Differentiable SpMV: training through the wavepack kernel (the port of
``hisparse_tpu/ops/autodiff.py``).

``DiffSpmv`` is ``y = A @ x`` as a ``torch.nn.Module`` over a
``torch.autograd.Function``, differentiable in both the CSR-order values
of A (its parameter ``vals``) and x:

* forward: the values are scattered into the packed stream (``emit_vals``;
  steal-mantissa src bits planted back) and run through ``wavepack_spmv``;
* ``dL/dx = A^T @ g`` runs through a second pack, of A^T, with the same
  kernel;
* ``dL/dvals[k] = g[row_k] * x[col_k]`` needs no kernel: two gathers and a
  multiply over the CSR coordinates.

The sparsity pattern is fixed when the module is built: the schedule reads
only the pattern, so one pack serves every value the optimizer steps to.
The port's operators carry no pad tiles, so the slot positions of
``formats/wavepack.slot_coords`` index the stream as they are (the JAX
package translates them through ``SpmvOperator.tile_src``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix, csr_to_csc
from ..formats.wavepack import pack, slot_coords
from .spmv import SpmvOperator


def canonicalize(m: CSRMatrix) -> CSRMatrix:
    """Sorted-indices, duplicate-summed, explicit-zero-free CSR (zero
    entries are not part of a trainable pattern: they are indistinguishable
    from pad slots in the stream)."""
    s = m.to_scipy().copy()
    s.sum_duplicates()
    s.eliminate_zeros()
    s.sort_indices()
    return CSRMatrix.from_scipy(s)


def wp_stream_map(wp):
    """(lin, rows, cols) in the matrix's CSR order for a wavepack: lin[k]
    is the flat slot position in the (T, S, 128) stream holding CSR nonzero
    k."""
    lin, rows, cols, _ = slot_coords(wp)
    order = np.lexsort((cols, rows))
    return lin[order], rows[order], cols[order]


def steal_src_bits(vals) -> np.ndarray:
    """The stolen-src low-bits plane of a steal-mantissa vals stream
    (flat int32; OR'd back into re-emitted value bits)."""
    bits = np.asarray(vals).view(np.uint32) & np.uint32(0x7F)
    return bits.astype(np.int32).reshape(-1)


def stream_map(wp):
    """(lin, rows, cols, src_bits) of a pack: ``wp_stream_map`` plus the
    stolen-src plane for steal-mantissa packs (a single 0 elsewhere)."""
    lin, rows, cols = wp_stream_map(wp)
    src = (steal_src_bits(wp.vals) if wp.config.steal_mantissa
           else np.zeros(1, np.int32))
    return lin, rows, cols, src


def emit_vals(v, lin, src_bits, steal: bool, shape) -> torch.Tensor:
    """Scatter CSR-order values into the stream layout ``shape``; pad
    slots stay at the plus_times identity (0).  Steal-mantissa packs
    re-plant the src field in the low 7 mantissa bits (the kernel reads
    the crossbar map from there), the format's standing 2^-17 value
    truncation."""
    flat = torch.zeros(int(np.prod(shape)), dtype=torch.float32,
                       device=v.device)
    flat[lin] = v.to(torch.float32)
    if steal:
        flat = ((flat.view(torch.int32) & -128) | src_bits).view(
            torch.float32)
    return flat.reshape(shape)


def check_trainable(cfg: SpmvConfig, what: str) -> None:
    if cfg.semiring != "plus_times" or cfg.dtype != "fp32":
        raise ValueError(f"{what} supports plus_times fp32 packs only")


class _DiffSpmvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, x, d):
        ctx.d = d
        ctx.save_for_backward(v, x)
        return d.op(x, vals=emit_vals(v, d.mapA, d.srcA, d.stealA,
                                      d.op.vals.shape))

    @staticmethod
    def backward(ctx, g):
        v, x = ctx.saved_tensors
        d = ctx.d
        v_bar = x_bar = None
        if ctx.needs_input_grad[1]:
            vt = emit_vals(v, d.mapT, d.srcT, d.stealT, d.opT.vals.shape)
            x_bar = d.opT(g, vals=vt).to(x.dtype)
        if ctx.needs_input_grad[0]:
            # the outer product restricted to the pattern: gathers only
            v_bar = (g[d.rows] * x[d.cols]).to(v.dtype)
        return v_bar, x_bar, None


class DiffSpmv(torch.nn.Module):
    """``y = A @ x`` differentiable in the CSR-order values ``vals`` (an
    ``nn.Parameter``, initialised to the canonical matrix's data) and in x.

    ``vals`` is in canonical CSR order (row-major, sorted columns, no
    explicit zeros; ``self.m`` is that matrix).  plus_times fp32 only.
    ``forward(x, vals=None)`` uses ``self.vals`` unless other values are
    given.  The packs of A and A^T live on ``device``; ``col_order`` /
    ``col_orderT`` and ``pack_kw`` go to their ``pack`` calls."""

    def __init__(self, m: CSRMatrix, config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None, *, device="cuda",
                 split_max="auto", col_order=None, col_orderT=None,
                 **pack_kw):
        super().__init__()
        m = canonicalize(m.astype(np.float32))
        cfg = config or SpmvConfig()
        cfgT = configT or cfg
        check_trainable(cfg, "DiffSpmv")
        check_trainable(cfgT, "DiffSpmv")
        self.m = m
        self.num_rows, self.num_cols = m.num_rows, m.num_cols
        self.wp = pack(m, cfg, split_max=split_max, col_order=col_order,
                       **pack_kw)
        self.op = SpmvOperator(self.wp, device)
        self.wpT = pack(csr_to_csc(m), cfgT, split_max=split_max,
                        col_order=col_orderT, **pack_kw)
        self.opT = SpmvOperator(self.wpT, device)
        dev = self.op.device

        linA, rowsA, colsA, srcA = stream_map(self.wp)
        # the slot provenance must enumerate exactly the CSR pattern
        rows_csr = np.repeat(np.arange(m.num_rows),
                             np.diff(m.indptr).astype(np.int64))
        if not (np.array_equal(rowsA, rows_csr)
                and np.array_equal(colsA, m.indices.astype(np.int64))):
            raise ValueError("the A pack's slot map does not enumerate the "
                             "matrix's CSR pattern")
        linT, rowsT, colsT, srcT = stream_map(self.wpT)
        # wpT is CSR over A's columns; re-sort to A's CSR order so one
        # vals vector drives both streams
        ordT = np.lexsort((rowsT, colsT))
        if not np.array_equal(colsT[ordT], rows_csr):
            raise ValueError("the A^T pack's slot map does not enumerate "
                             "the matrix's CSR pattern")
        linT = linT[ordT]

        def buf(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self.register_buffer("mapA", buf(linA, np.int64))
        self.register_buffer("mapT", buf(linT, np.int64))
        self.register_buffer("srcA", buf(srcA, np.int32))
        self.register_buffer("srcT", buf(srcT, np.int32))
        self.register_buffer("rows", buf(rows_csr, np.int64))
        self.register_buffer("cols", buf(m.indices, np.int64))
        self.stealA = cfg.steal_mantissa
        self.stealT = cfgT.steal_mantissa
        self.vals = torch.nn.Parameter(buf(m.data, np.float32))

    def forward(self, x, vals=None) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.op.device)
        return _DiffSpmvFn.apply(self.vals if vals is None else vals, x,
                                 self)
