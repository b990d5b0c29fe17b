"""Stream-layout training: gradients computed in the packed layout by a
kernel (the port of ``hisparse_tpu/ops/train_stream.py``).

``DiffSpmv`` keeps the values as one CSR-order vector and scatters them
into both packed streams on every call.  ``StreamDiffSpmv`` trains the two
packed value streams themselves instead:

  * the parameters are ``vA`` (the A pack's value stream) and ``vT`` (the
    A^T pack's), two layouts of one set of values, with pad slots held at
    0 by a static mask;
  * the forward and ``dL/dx`` run ``wavepack_spmv`` on those streams
    directly;
  * ``dL/dvA`` and ``dL/dvT`` come from ``wavepack_gradstream``: per slot,
    ``g[row(slot)] * x_routed[slot]``, each in its own layout;
  * elementwise updates keep the two layouts consistent without mapping
    between them: the slots of vA and vT that hold one CSR entry see the
    same (value, gradient) pair, and identical fp32 arithmetic gives
    identical results.  Steal-mantissa packs strip their planted src bits
    before the update (``clean``) and re-plant them after (``replant``).

plus_times fp32 only.  The JAX package's resident-only check is VMEM
bookkeeping of the TPU and has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import CSRMatrix
from .autodiff import DiffSpmv
from .spmv import build_xt, wavepack_gradstream


def bcast_to_acc(vec_ext, perm, n_blocks: int, S: int, R: int):
    """Broadcast a renamed-space vector to the (n_blocks*S, 128)
    accumulator geometry: row (b, q*R + r, l) reads renamed slot (b, r, l),
    the transpose of ``stripe_fold``'s (S//R, R) split.  ``vec_ext`` is
    the natural-order vector with one 0 appended for the padding rows
    (perm == num_rows)."""
    ren = vec_ext[perm].reshape(n_blocks, R, 128)
    return ren[:, None].expand(n_blocks, S // R, R, 128).reshape(-1, 128)


def with_bits(v, plant):
    """v with its low 7 mantissa bits cleared and, if ``plant`` is given,
    set to it: the steal-mantissa clean and replant."""
    bits = v.view(torch.int32) & -128
    return (bits if plant is None else bits | plant).view(torch.float32)


def grad_stream_operands(op, vals, mask, g, x):
    """The operands of ``wavepack_gradstream`` for dL/dvals of ``op``'s
    stream ``vals``, given the output cotangent ``g`` (natural row order)
    and the input ``x`` (natural column order)."""
    cfg, wp = op.cfg, op.wp
    g = g.to(torch.float32)
    g_acc = bcast_to_acc(torch.cat([g, g.new_zeros(1)]), op.perm,
                         wp.n_blocks, cfg.sublanes, cfg.stripes)
    if op.col_order is not None:
        x = x[op.col_order]
    return (vals, op.idxT, mask, op.tile_part, op.tile_block, op.class_map,
            g_acc, build_xt(x, cfg, wp.n_parts), cfg)


class _StreamSpmvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vA, vT, x, sd):
        ctx.sd = sd
        ctx.save_for_backward(vA, vT, x)
        return sd.d.op(x, vals=vA)

    @staticmethod
    def backward(ctx, g):
        vA, vT, x = ctx.saved_tensors
        sd = ctx.sd
        op, opT = sd.d.op, sd.d.opT
        need_A, need_T, need_x = ctx.needs_input_grad[:3]
        # each view of the one parameter gets its own copy of dL/dvals:
        # the partial for vT is not zero
        gA = (wavepack_gradstream(*grad_stream_operands(
            op, vA, sd.maskA, g, x)) if need_A else None)
        gT = (wavepack_gradstream(*grad_stream_operands(
            opT, vT, sd.maskT, x, g)) if need_T else None)
        x_bar = opT(g, vals=vT).to(x.dtype) if need_x else None
        return gA, gT, x_bar, None


class StreamDiffSpmv(torch.nn.Module):
    """``y = A @ x`` trainable in stream layout; see the module docstring.

    The parameters ``vA`` and ``vT`` (``nn.Parameter``s in the shapes of
    the A and A^T packs' value streams) start as the packed streams,
    steal bits included.  They are two views of one set of values: the
    backward gives each its own copy of dL/dvals, so apply the same
    elementwise update to both.  :meth:`sgd_step` does that IN PLACE,
    under ``torch.no_grad()``: clean -> update -> replant.  ``self.d`` is
    the :class:`DiffSpmv` over the same packs (its CSR-order ``vals`` are
    not used here)."""

    def __init__(self, m: CSRMatrix, config: SpmvConfig | None = None,
                 configT: SpmvConfig | None = None, *, device="cuda",
                 split_max="auto", col_order=None, col_orderT=None,
                 **pack_kw):
        super().__init__()
        d = DiffSpmv(m, config, configT, device=device, split_max=split_max,
                     col_order=col_order, col_orderT=col_orderT, **pack_kw)
        self.d = d
        self.m = d.m
        self.num_rows, self.num_cols = d.num_rows, d.num_cols

        def mask_of(op, lin):
            mk = torch.zeros(op.vals.numel(), dtype=torch.float32,
                             device=op.device)
            mk[lin] = 1.0
            return mk.reshape(op.vals.shape)

        self.register_buffer("maskA", mask_of(d.op, d.mapA))
        self.register_buffer("maskT", mask_of(d.opT, d.mapT))
        self.register_buffer(
            "splantA", d.srcA.reshape(d.op.vals.shape) if d.stealA else None)
        self.register_buffer(
            "splantT", d.srcT.reshape(d.opT.vals.shape) if d.stealT else None)
        self.vA = torch.nn.Parameter(d.op.vals.clone())
        self.vT = torch.nn.Parameter(d.opT.vals.clone())

    # -- value plumbing: host readback for checks -----------------------
    def _csr(self, v, lin, steal: bool) -> np.ndarray:
        v = v.detach().reshape(-1)[lin].cpu().numpy()
        if steal:
            v = (v.view(np.uint32) & np.uint32(0xFFFFFF80)).view(np.float32)
        return v

    def values(self, vA=None) -> np.ndarray:
        """CSR-order values read back from an A-layout stream."""
        return self._csr(self.vA if vA is None else vA, self.d.mapA,
                         self.d.stealA)

    def values_T(self, vT=None) -> np.ndarray:
        """CSR-order values read back from an A^T-layout stream."""
        return self._csr(self.vT if vT is None else vT, self.d.mapT,
                         self.d.stealT)

    def grads_csr(self, gA) -> np.ndarray:
        """CSR-order dL/dvals read back from an A-layout gradient."""
        return self._csr(gA, self.d.mapA, False)

    # -- the differentiable step ----------------------------------------
    def forward(self, x, vA=None, vT=None) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.d.op.device)
        return _StreamSpmvFn.apply(self.vA if vA is None else vA,
                                   self.vT if vT is None else vT, x, self)

    def clean(self, vA, vT):
        """Strip each layout's planted src bits, so that update arithmetic
        sees the clean value plane, identical across layouts (identity for
        non-steal packs)."""
        return (with_bits(vA, None) if self.d.stealA else vA,
                with_bits(vT, None) if self.d.stealT else vT)

    def replant(self, vA, vT):
        """Re-truncate and re-plant the steal-mantissa src bits after an
        elementwise update (identity for non-steal packs)."""
        return (with_bits(vA, self.splantA) if self.d.stealA else vA,
                with_bits(vT, self.splantT) if self.d.stealT else vT)

    @torch.no_grad()
    def sgd_step(self, lr: float, gA=None, gT=None) -> None:
        """One SGD step on both layouts, in place: clean -> ``v - lr*g``
        -> replant.  ``gA`` / ``gT`` default to the parameters' ``.grad``."""
        gA = self.vA.grad if gA is None else gA
        gT = self.vT.grad if gT is None else gT
        vA, vT = self.clean(self.vA, self.vT)
        vA, vT = self.replant(vA - lr * gA, vT - lr * gT)
        self.vA.copy_(vA)
        self.vT.copy_(vT)
