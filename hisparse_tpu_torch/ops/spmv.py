"""Packed-stream SpMV in PyTorch: the port of ``hisparse_tpu/ops/spmv.py``'s
main path (``SpmvOperator`` -> ``_spmv_call`` -> ``_stripe_fold`` ->
``unpack_device``).

Per call, for a dense vector x:

  1. ``build_xt``       x -> XT, the (n_parts, CT, 128, 128) bank blocks
                        (plus the two-choice rotated copies);
  2. ``wavepack_spmv``  the tile stream -> the (n_blocks*S, 128) positional
                        accumulator: the CUDA kernel of
                        ``csrc/wavepack_spmv.cu`` for CUDA tensors, the
                        plain PyTorch version ``spmv_tiles_plain`` for CPU
                        tensors;
  3. ``stripe_fold``    S/R sublane rows -> R rows per block (renamed y);
  4. ``unpack_device``  renamed y -> natural row order (hub-split partials
                        summed).

This slice covers fp32 plus_times packs: select-chain and block-major,
two_choice, steal_mantissa, idx16, any number of column partitions.  bf16
values, the min_plus / max_times semirings and fixed-point Q8.24 raise
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import LANES, SpmvConfig
from ..formats.wavepack import Wavepack, bank_shift
from . import _kernels


def check_supported(cfg: SpmvConfig) -> None:
    """Raise ``NotImplementedError`` for a pack this slice cannot run."""
    if cfg.dtype != "fp32":
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: only fp32 packs are ported so far")
    if cfg.semiring != "plus_times":
        raise NotImplementedError(
            f"semiring {cfg.semiring!r}: only plus_times is ported so far")


def build_xt(x: torch.Tensor, cfg: SpmvConfig, n_parts: int) -> torch.Tensor:
    """Vector-loader analog (``hisparse_tpu/ops/spmv.py:_build_xt``):
    XT[p, b, l, h] = x[p*VB + (b*128 + h)*128 + l], plus the two-choice
    second copy of every block.  Returns a contiguous float32 tensor of
    shape (n_parts, CT, 128, 128) on x's device."""
    check_supported(cfg)
    B = cfg.bank_blocks
    x = x.to(torch.float32)
    x_padded = torch.nn.functional.pad(
        x, (0, n_parts * cfg.vb_cols - x.shape[0]))
    xt = x_padded.reshape(n_parts, B, 128, LANES).transpose(2, 3)
    if cfg.two_choice:
        if cfg.block_major:
            # cross-class second copy: class B+b' holds columns a = h2*B+b'
            # at address h2 with a per-class lane rotation (stride layout)
            x2 = x_padded.reshape(n_parts, 128, B, LANES)
            second = [torch.roll(x2[:, :, b, :], bank_shift(b),
                                 dims=2).transpose(1, 2)
                      for b in range(B)]
        else:
            second = [torch.roll(xt[:, b], bank_shift(b), dims=1)
                      for b in range(B)]
        xt = torch.cat([xt, torch.stack(second, dim=1)], dim=1)
    return xt.contiguous()


def block_runs(tile_block: np.ndarray, n_blocks: int):
    """Each row block's tile run ``[start, end)`` in the stream, as two
    int32 arrays of length n_blocks (empty blocks get start == end == 0).
    Raises ``ValueError`` if a block's tiles are not one contiguous run."""
    tb = np.asarray(tile_block)
    start = np.zeros(n_blocks, np.int32)
    end = np.zeros(n_blocks, np.int32)
    if tb.size == 0:
        return start, end
    if tb.min() < 0 or tb.max() >= n_blocks:
        raise ValueError("tile_block holds a block id outside "
                         f"[0, {n_blocks})")
    heads = np.flatnonzero(np.r_[True, tb[1:] != tb[:-1]])
    blocks = tb[heads]
    if np.unique(blocks).size != blocks.size:
        raise ValueError("a row block's tiles are not one contiguous run "
                         "of the stream")
    start[blocks] = heads
    end[blocks] = np.r_[heads[1:], tb.size]
    return start, end


def _n_ops(cfg: SpmvConfig) -> int:
    return cfg.classes_per_group if cfg.block_major else cfg.total_blocks


def spmv_tiles_plain(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                     cfg: SpmvConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``_route_x`` + ``_tile_routed``
    + ``_tile_body`` for fp32 plus_times, vectorised over tiles).

    Returns the (n_blocks*S, 128) accumulator.  Each block sums its tiles
    in stream order, multiply and add rounded separately, as the kernel
    does."""
    check_supported(cfg)
    T, S, _ = vals.shape
    G = S // 128
    dev = vals.device
    idx = idxT.to(torch.int32)
    # undo the per-group transpose: packed[t, g*128 + r, j] is the word of
    # gather slot (g*128 + r, j), stored at idxT[t, g*128 + j, r]
    packed = idx.reshape(T, G, 128, 128).transpose(2, 3).reshape(T, S, LANES)
    h = packed & 0x7F
    n_ops = _n_ops(cfg)
    if cfg.steal_mantissa:
        vbits = vals.view(torch.int32)
        src = vbits & 0x7F
        v = (vbits & -128).view(torch.float32)
        # the whole word is b*128 + h: the select chain (w >= i*128) keeps
        # the highest operand i it reaches
        op = torch.clamp(packed >> 7, 0, n_ops - 1)
    else:
        src = (packed >> 11) & 0x7F
        v = vals
        b = (packed >> 7) & 0xF
        op = torch.where(b < n_ops, b, torch.zeros_like(b))
    if cfg.block_major:
        K = cfg.classes_per_group
        g_of_s = torch.arange(S, device=dev) // 128
        flat = ((torch.arange(T, device=dev)[:, None, None] * G
                 + g_of_s[None, :, None]) * K + op)
        blk = cmap.reshape(-1)[flat]
    else:
        blk = op
    lane = torch.arange(LANES, device=dev)
    part = tile_part.long()[:, None, None]
    gx = xt[part, blk.long(), lane, h.long()]        # x at gather slots
    routed = torch.gather(gx, 2, src.long())         # crossbar by src
    prod = v * routed
    n_blocks = run_start.shape[0]
    acc = torch.zeros(n_blocks, S, LANES, dtype=torch.float32, device=dev)
    lengths = (run_end - run_start).long()
    starts = run_start.long()
    for k in range(int(lengths.max()) if n_blocks else 0):
        live = torch.nonzero(lengths > k).squeeze(1)
        acc[live] = acc[live] + prod[starts[live] + k]
    return acc.reshape(n_blocks * S, LANES)


def wavepack_spmv(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                  cfg: SpmvConfig) -> torch.Tensor:
    """The tile stream -> the (n_blocks*S, 128) accumulator.

    On CUDA tensors this launches ``csrc/wavepack_spmv.cu``; on CPU
    tensors it runs :func:`spmv_tiles_plain`.  Blocks without tiles come
    out at 0, the plus_times identity.  The kernel trusts the values of
    its operands: runs from :func:`block_runs`, partition and class ids in
    range (``SpmvOperator`` checks both on the host when it is built);
    this wrapper checks device, dtype, shape and contiguity."""
    check_supported(cfg)
    if vals.device.type == "cpu":
        return spmv_tiles_plain(vals, idxT, tile_part, cmap, run_start,
                                run_end, xt, cfg)
    if vals.device.type != "cuda":
        raise ValueError(f"no wavepack_spmv kernel for {vals.device}")
    T, S, lanes = vals.shape
    G, K = S // 128, cfg.classes_per_group
    idx_dtype = torch.int16 if cfg.idx16 else torch.int32
    n_parts = xt.shape[0]
    checks = [
        (vals, torch.float32, (T, S, LANES)),
        (idxT, idx_dtype, (T, S, LANES)),
        (tile_part, torch.int32, (T,)),
        (run_start, torch.int32, run_start.shape),
        (run_end, torch.int32, run_start.shape),
        (xt, torch.float32, (n_parts, cfg.total_blocks, 128, 128)),
    ]
    if cfg.block_major:
        checks.append((cmap, torch.int32, (T, G, K)))
    if lanes != LANES or S % 128 or run_start.dim() != 1:
        raise ValueError(f"vals must be (T, S, {LANES}) with S % 128 == 0 "
                         "and one run per block")
    for t, dtype, shape in checks:
        if t.device != vals.device:
            raise ValueError(f"operand on {t.device}, vals on {vals.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
        if not t.is_contiguous():
            raise ValueError("wavepack_spmv operands must be contiguous")
    out = torch.empty(run_start.shape[0] * S, LANES, dtype=torch.float32,
                      device=vals.device)
    _kernels.launch_wavepack_spmv(
        vals, idxT, tile_part, cmap if cfg.block_major else None,
        run_start, run_end, xt, out, steal=cfg.steal_mantissa,
        block_major=cfg.block_major, n_ops=_n_ops(cfg), K=K)
    return out


def stripe_fold(acc: torch.Tensor, cfg: SpmvConfig,
                n_blocks: int) -> torch.Tensor:
    """(n_blocks*S, 128) accumulator -> (n_blocks, R, 128) rows: the S/R
    sublanes of stripe sigma sum into row sigma (PE output stage)."""
    check_supported(cfg)
    S, R = cfg.sublanes, cfg.stripes
    return acc.reshape(n_blocks, S // R, R, LANES).sum(dim=1)


class SpmvOperator(torch.nn.Module):
    """Device-resident packed matrix + SpMV (the port of
    ``hisparse_tpu.ops.spmv.SpmvOperator``).

    Construct once from a :class:`Wavepack` on an explicit device, then
    call with dense vectors.  ``forward(x)`` returns y in natural row
    order as a tensor on the operator's device; ``renamed=True`` returns
    the packed row order.  With a pack ``col_order``, x is given in
    natural column order and permuted on the device (``permute_x=False``
    when the caller already feeds packed-order x)."""

    def __init__(self, wp: Wavepack, device, permute_x: bool = True):
        super().__init__()
        cfg = wp.config
        check_supported(cfg)
        self.wp = wp
        self.cfg = cfg
        self.device = torch.device(device)
        T = wp.num_tiles
        part = np.asarray(wp.tile_part)
        if part.shape != (T,) or (T and (part.min() < 0
                                         or part.max() >= wp.n_parts)):
            raise ValueError("tile_part must hold one partition id in "
                             f"[0, {wp.n_parts}) per tile")
        cmap = None
        if cfg.block_major:
            cmap = np.asarray(wp.class_map, np.int32)
            if cmap.size and (cmap.min() < 0
                              or cmap.max() >= cfg.total_blocks):
                raise ValueError("class_map holds a block outside "
                                 f"[0, {cfg.total_blocks})")
        start, end = block_runs(wp.tile_block, wp.n_blocks)

        def buf(a, dtype=None):
            a = np.ascontiguousarray(a, dtype)
            return torch.from_numpy(a).to(self.device)

        self.register_buffer("vals", buf(wp.vals, np.float32))
        self.register_buffer(
            "idxT", buf(wp.idxT, np.int16 if cfg.idx16 else np.int32))
        self.register_buffer("tile_part", buf(part, np.int32))
        self.register_buffer(
            "class_map", buf(cmap) if cmap is not None else None)
        self.register_buffer("run_start", buf(start))
        self.register_buffer("run_end", buf(end))
        self.register_buffer("perm", buf(wp.perm, np.int64))
        self.register_buffer(
            "col_order",
            buf(wp.col_order, np.int64)
            if permute_x and wp.col_order is not None else None)

    def stream_args(self, x: torch.Tensor):
        """The operands of :func:`wavepack_spmv` for packed-order x."""
        xt = build_xt(x, self.cfg, self.wp.n_parts)
        return (self.vals, self.idxT, self.tile_part, self.class_map,
                self.run_start, self.run_end, xt)

    def renamed_y(self, acc: torch.Tensor) -> torch.Tensor:
        """Accumulator -> y in packed (renamed) row order."""
        return stripe_fold(acc, self.cfg, self.wp.n_blocks).reshape(-1)

    def unpack_device(self, y_renamed: torch.Tensor) -> torch.Tensor:
        """Renamed -> natural-row-order y on the device: one ``index_add_``
        over the stored perm sums hub-split partials (padding rows map to
        ``num_rows`` and are dropped).  On CUDA the partials of one row add
        in no fixed order."""
        n = self.wp.num_rows
        out = torch.zeros(n + 1, dtype=y_renamed.dtype,
                          device=y_renamed.device)
        out.index_add_(0, self.perm, y_renamed)
        return out[:n]

    def forward(self, x, renamed: bool = False) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        if x.shape != (self.wp.num_cols,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.wp.num_cols},)")
        if self.col_order is not None:
            x = x[self.col_order]
        acc = wavepack_spmv(*self.stream_args(x), self.cfg)
        y = self.renamed_y(acc)
        return y if renamed else self.unpack_device(y)


def spmv(wp: Wavepack, x, device) -> torch.Tensor:
    """One-shot SpMV y = A @ x from a packed matrix."""
    return SpmvOperator(wp, device=device)(x)
