"""Packed-stream SpMV and SpMM in PyTorch: the port of
``hisparse_tpu/ops/spmv.py``'s main path (``SpmvOperator`` ->
``_spmv_call`` -> ``_stripe_fold`` -> ``unpack_device``), of its SpMM
(``SpmvOperator.matmul`` -> ``_spmm_call``), of its masked SpMSpV analog
(``SpmvOperator.masked`` -> ``_spmv_masked_call``) and of its gradient
stream (``_gradstream_call``).

Per SpMV call, for a dense vector x:

  1. ``build_xt``       x -> XT, the (n_parts, CT, 128, 128) bank blocks
                        (plus the two-choice rotated copies);
  2. ``wavepack_spmv``  the tile stream -> the (n_blocks*S, 128) positional
                        accumulator: the CUDA kernel of
                        ``csrc/wavepack_spmv.cu`` for CUDA tensors, the
                        plain PyTorch version ``spmv_tiles_plain`` for CPU
                        tensors;
  3. ``stripe_fold``    S/R sublane rows -> R rows per block (renamed y);
  4. ``unpack_device``  renamed y -> natural row order (hub-split partials
                        combined): ``row_fold``, the CUDA kernel of
                        ``csrc/row_fold.cu`` for CUDA tensors, the plain
                        version ``row_fold_plain`` for CPU tensors, both
                        folding each row's partials in ascending renamed
                        order, as ``Wavepack.unpack_y`` does.

Each step follows the pack's semiring: plus_times sums products, min_plus
takes the least v + x, max_times the greatest v * x (natural-order rows
with no term come out at 0, the JAX package's clamp).  Accumulators start
at the semiring's identity (0, +inf, -inf), so a row block without tiles
comes out at the identity, as the JAX resident init and paged fill leave
it.  min and max propagate a NaN, as ``jnp.minimum`` / ``torch.minimum``
do.

SpMM runs the same steps for up to 16 feature columns at a time
(``build_xt_multi``, whose XT keeps a slot's features innermost, and
``wavepack_spmm`` / ``spmm_tiles_plain``).  The masked
call (``wavepack_spmv_masked`` / ``spmv_masked_tiles_plain``) walks only
the tiles ``SpmvOperator.active_tiles`` selects: those whose partition, or
whose block-major (partition, class) pairs, can touch an active column.
It selects single tiles where the JAX package selects groups of ``tb``
tiles; ``_ensure_pad_group``, the power-of-two padding of the selection
and the ``first`` re-derivation are not ported, as they exist only to
bound TPU recompiles and to serve the paged index maps.  The gradient
stream ``wavepack_gradstream`` / ``gradstream_tiles_plain`` gives dL/dvals
in the pack's stream layout (plus_times only).  The kernels and their
plain versions share one routing: ``csrc/route.cuh`` and ``route_plain``.

Every pack ``config.py`` allows runs: select-chain and block-major,
two_choice, steal_mantissa, idx16, any number of column partitions, the
three semirings in fp32, and plus_times over bf16 values or saturating
unsigned Q8.24 (the fourth algebra, ``"fixed"``).  A bf16 stream is held
on the device as ``torch.bfloat16`` (2 B a value) and widened to fp32 per
term; x and the accumulator stay fp32.  A Q8.24 stream, its x and its
accumulator are uint32 words carried in int32 tensors (torch has few
uint32 ops); the plain versions widen them to int64.  Q8.24 packs run SpMV
only: ``matmul``, ``masked`` and ``unpack_device`` raise ``ValueError``,
as the JAX package's do, and ``forward`` recombines hub-split rows with the
same fold, its saturating form (an int64 sum clamped at ``FIX_MAX``,
``Wavepack.unpack_y``'s closed form), on the device until one final copy.
The gradient stream is fp32 plus_times.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import LANES, SpmvConfig
from ..formats.wavepack import Wavepack, bank_shift
from . import _kernels

SPMM_MAX_F = 16              # features per SpMM kernel launch
# slots the plain versions route at once: they walk a long stream in
# chunks of tiles (the SSSP pokec pack has 680M slots), so that their int64
# routing offsets stay near a GB
PLAIN_CHUNK_SLOTS = 1 << 24
IDENTITY = {"plus_times": 0.0, "min_plus": float("inf"),
            "max_times": float("-inf"), "fixed": 0}
FIX_MAX = 0xFFFFFFFF          # Q8.24 saturates at the all-ones word
# the device dtype of each stream value type
VALUE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "fixed": torch.int32}
# a natural row of up to this many partials folds on one thread of the
# fold kernel; a longer (hub) row on one warp (csrc/row_fold.cu)
FOLD_THREAD_MAX = 32


def algebra(cfg: SpmvConfig) -> str:
    """What a pack's kernels fold: its semiring, or ``"fixed"`` (the
    saturating Q8.24 multiply-add) for a Q8.24 pack."""
    return "fixed" if cfg.dtype == "fixed" else cfg.semiring


def acc_dtype(cfg: SpmvConfig) -> torch.dtype:
    """The dtype of x, XT and the accumulator: int32 (Q8.24 words) for a
    Q8.24 pack, else float32."""
    return torch.int32 if cfg.dtype == "fixed" else torch.float32


def check_float(cfg: SpmvConfig, what: str) -> None:
    """Raise ``ValueError`` for a Q8.24 pack, which ``what`` does not
    take (the JAX package refuses it too)."""
    if cfg.dtype == "fixed":
        raise ValueError(f"{what} supports float packs only")


def check_plus_times(cfg: SpmvConfig, what: str) -> None:
    """Raise ``NotImplementedError`` unless the pack is fp32 plus_times,
    the only algebra ``what`` is defined for."""
    if cfg.dtype != "fp32" or cfg.semiring != "plus_times":
        raise NotImplementedError(
            f"{cfg.dtype} {cfg.semiring}: {what} is fp32 plus_times only")


def fixed_bits(x) -> torch.Tensor:
    """Q8.24 x as its uint32 words in an int32 tensor: a numpy uint32 array
    or a uint32 or int32 tensor is taken as the words, any other numpy
    input is quantized first (``ops/golden.float_to_fixed``, as the JAX
    operator's ``__call__`` does)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.int32, torch.uint32):
            return x.view(torch.int32)
        x = x.cpu().numpy()
    a = np.asarray(x)
    if a.dtype != np.uint32:
        from .golden import float_to_fixed
        a = float_to_fixed(a)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32-carried uint32 words -> their values in int64."""
    return t.to(torch.int64) & FIX_MAX


def _to_words(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same words in int32."""
    return torch.where(t > 0x7FFFFFFF, t - (1 << 32), t).to(torch.int32)


def semiring_term(v, x, semiring: str):
    """The term ``v (x) x`` of each slot, rounded once: ``v + x`` for
    min_plus, ``v * x`` otherwise.  For ``"fixed"`` (int64 operands in
    [0, 2^32)) the Q8.24 product with round-half-up, saturated at
    ``FIX_MAX``: ``v*x + 2^23`` reaches 2^64, so ``v`` is split into 16-bit
    limbs, ``hi = (v >> 16)*x`` and ``lo = (v & 0xFFFF)*x + 2^23``, and
    ``(v*x + 2^23) >> 24 = (hi + (lo >> 16)) >> 8``, every step inside
    int64 (``_fixed_madd``'s limbs, two of them)."""
    if semiring == "fixed":
        hi = (v >> 16) * x
        lo = (v & 0xFFFF) * x + (1 << 23)
        return torch.clamp_max((hi + (lo >> 16)) >> 8, FIX_MAX)
    return v + x if semiring == "min_plus" else v * x


def semiring_add(acc, t, semiring: str):
    """``acc (+) t`` elementwise, as the kernels fold a term: ``acc + t``,
    ``min(acc, t)`` or ``max(acc, t)``.  min and max take the term where it
    is smaller (larger) or NaN, so a NaN propagates and a tie keeps
    ``acc``.  ``"fixed"`` adds with saturation at ``FIX_MAX`` (int64
    operands)."""
    if semiring == "min_plus":
        return torch.where((t < acc) | torch.isnan(t), t, acc)
    if semiring == "max_times":
        return torch.where((t > acc) | torch.isnan(t), t, acc)
    if semiring == "fixed":
        return torch.clamp_max(acc + t, FIX_MAX)
    return acc + t


def build_xt(x: torch.Tensor, cfg: SpmvConfig, n_parts: int) -> torch.Tensor:
    """Vector-loader analog (``hisparse_tpu/ops/spmv.py:_build_xt``):
    XT[p, b, l, h] = x[p*VB + (b*128 + h)*128 + l], plus the two-choice
    second copy of every block.  Returns a contiguous tensor of shape
    (n_parts, CT, 128, 128) on x's device: float32, or for a Q8.24 pack the
    raw words of x (int32 or uint32 x, kept as int32)."""
    B = cfg.bank_blocks
    if cfg.dtype == "fixed":
        if x.dtype not in (torch.int32, torch.uint32):
            raise ValueError("a Q8.24 pack takes x as its uint32 words "
                             "(fixed_bits)")
        x = x.view(torch.int32)
    else:
        # bf16 streams compress the matrix values only; x stays fp32
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


def build_xt_multi(X: torch.Tensor, cfg: SpmvConfig,
                   n_parts: int) -> torch.Tensor:
    """Multi-feature vector loader: (num_cols, F) -> (n_parts, CT, 128,
    128, Fp), XT[p, b, l, h, f] = X[p*VB + (b*128 + h)*128 + l, f] plus the
    two-choice second copy of every block, with Fp = F rounded up to a
    multiple of 4 and the padding features 0.  Feature-innermost, so the
    SpMM kernel reads a routed slot's features as Fp/4 16-byte loads of
    one row; XT[..., f] is ``build_xt(X[:, f])``.  One pass over X for all
    features (float packs only)."""
    B = cfg.bank_blocks
    F = X.shape[1]
    Fp = -(-F // 4) * 4
    x_padded = torch.nn.functional.pad(
        X.to(torch.float32),
        (0, Fp - F, 0, n_parts * cfg.vb_cols - X.shape[0]))
    xt = x_padded.reshape(n_parts, B, 128, LANES, Fp).transpose(2, 3)
    if cfg.two_choice:
        if cfg.block_major:
            x2 = x_padded.reshape(n_parts, 128, B, LANES, Fp)
            second = [torch.roll(x2[:, :, b], bank_shift(b),
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


def route_plain(vals, idxT, tile_part, cmap, cfg: SpmvConfig, CT: int):
    """Plain PyTorch version of the kernels' routing (``csrc/route.cuh``;
    the TPU's ``_route_x`` + ``_tile_routed`` for fp32), vectorised over
    the stream.

    Returns ``(v, off)``: ``v`` the (T, S, 128) values with the stolen src
    bits of steal_mantissa packs cleared (bf16 widened to float32, Q8.24
    words widened to int64), and ``off`` the int64 flat offset of each
    slot's routed x in an XT of shape (n_parts, CT, 128, 128): XT[part[t],
    blk, src, h], with src the slot's crossbar lane and (blk, h) decoded
    from the idx word of gather slot (s, src)."""
    T, S, _ = vals.shape
    G = S // 128
    dev = vals.device
    idx = idxT.to(torch.int32)
    # undo the per-group transpose: packed[t, g*128 + r, j] is the word of
    # gather slot (g*128 + r, j), stored at idxT[t, g*128 + j, r]
    packed = idx.reshape(T, G, 128, 128).transpose(2, 3).reshape(T, S, LANES)
    if cfg.steal_mantissa:
        vbits = vals.view(torch.int32)
        src = (vbits & 0x7F).long()
        v = (vbits & -128).view(torch.float32)
    else:
        src = ((packed >> 11) & 0x7F).long()
        v = _u32(vals) if cfg.dtype == "fixed" else vals.to(torch.float32)
    w = torch.gather(packed, 2, src)          # word of gather slot (s, src)
    n_ops = _n_ops(cfg)
    if cfg.steal_mantissa:
        # the whole word is b*128 + h: the select chain (w >= i*128) keeps
        # the highest operand i it reaches
        op = torch.clamp(w >> 7, 0, n_ops - 1)
    else:
        b = (w >> 7) & 0xF
        op = torch.where(b < n_ops, b, torch.zeros_like(b))
    if cfg.block_major:
        K = cfg.classes_per_group
        g_of_s = torch.arange(S, device=dev) // 128
        flat = ((torch.arange(T, device=dev)[:, None, None] * G
                 + g_of_s[None, :, None]) * K + op)
        blk = cmap.reshape(-1)[flat]
    else:
        blk = op
    part = tile_part.long()[:, None, None]
    off = ((part * CT + blk.long()) * 128 + src) * LANES + (w & 0x7F).long()
    return v, off


def _accumulate_runs(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                     n_feat: int, cfg: SpmvConfig,
                     tile_ids=None) -> torch.Tensor:
    """The plain versions' accumulation: each block's semiring sum of its
    run's terms, in run order, from the semiring's identity.  A run
    indexes ``tile_ids`` (the masked call) if given, else the stream.
    ``xt`` is build_xt's (n_parts, CT, 128, 128) or build_xt_multi's
    (n_parts, CT, 128, 128, Fp); returns the (n_feat, n_blocks*S, 128)
    accumulators of its first n_feat features.

    The run space is walked in chunks of ``PLAIN_CHUNK_SLOTS`` slots,
    routed once for all features, the accumulator carried from chunk to
    chunk, so each slot still folds its terms in run order."""
    _, S, _ = vals.shape
    sr = algebra(cfg)
    n_blocks = run_start.shape[0]
    n_runs = vals.shape[0] if tile_ids is None else tile_ids.shape[0]
    fp = xt.shape[4] if xt.dim() == 5 else 1
    xflat = xt.reshape(-1)
    acc = torch.full((n_feat, n_blocks, S, LANES), IDENTITY[sr],
                     dtype=torch.int64 if sr == "fixed" else torch.float32,
                     device=vals.device)
    starts, ends = run_start.long(), run_end.long()
    step = max(1, PLAIN_CHUNK_SLOTS // (S * LANES))
    for c0 in range(0, n_runs if n_blocks else 0, step):
        c1 = min(n_runs, c0 + step)
        lo = starts.clamp(c0, c1)
        lengths = ends.clamp(c0, c1) - lo
        depth = int(lengths.max())
        if depth == 0:
            continue
        tiles = (slice(c0, c1) if tile_ids is None
                 else tile_ids[c0:c1].long())
        v, off = route_plain(vals[tiles], idxT[tiles], tile_part[tiles],
                             None if cmap is None else cmap[tiles], cfg,
                             xt.shape[1])
        off = off * fp
        for f in range(n_feat):
            x = xflat[off + f]
            term = semiring_term(v, _u32(x) if sr == "fixed" else x, sr)
            for k in range(depth):
                live = torch.nonzero(lengths > k).squeeze(1)
                acc[f, live] = semiring_add(acc[f, live],
                                            term[lo[live] + (k - c0)], sr)
    acc = acc.reshape(n_feat, n_blocks * S, LANES)
    return _to_words(acc) if sr == "fixed" else acc


def spmv_tiles_plain(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                     cfg: SpmvConfig) -> torch.Tensor:
    """Plain PyTorch version of the SpMV kernel (``_tile_body`` over the
    stream).

    Returns the (n_blocks*S, 128) accumulator.  Each block folds its tiles
    in stream order, every operation rounded once, as the kernel does."""
    return _accumulate_runs(vals, idxT, tile_part, cmap, run_start, run_end,
                            xt, 1, cfg)[0]


def spmv_masked_tiles_plain(vals, idxT, tile_ids, tile_part, cmap,
                            run_start, run_end, xt,
                            cfg: SpmvConfig) -> torch.Tensor:
    """Plain PyTorch version of the masked SpMV kernel: the SpMV over the
    tiles ``tile_ids`` (stream order) alone, ``run_start`` / ``run_end``
    each block's run into ``tile_ids``."""
    check_float(cfg, "the masked path")
    return _accumulate_runs(vals, idxT, tile_part, cmap, run_start, run_end,
                            xt, 1, cfg, tile_ids=tile_ids)[0]


def gradstream_tiles_plain(vals, idxT, mask, tile_part, tile_block, cmap,
                           g_acc, xt, cfg: SpmvConfig) -> torch.Tensor:
    """Plain PyTorch version of the gradient-stream kernel
    (``_gradstream_kernel``): ``out[t, s, l] = g_acc[block[t]*S + s, l] *
    routed[t, s, l] * mask[t, s, l]``, the two products rounded in that
    order.  ``vals`` is read only for the stolen src bits."""
    check_plus_times(cfg, "the gradient stream")
    _, off = route_plain(vals, idxT, tile_part, cmap, cfg, xt.shape[1])
    S = vals.shape[1]
    gb = g_acc.reshape(-1, S, LANES)[tile_block.long()]
    return gb * xt.reshape(-1)[off] * mask


def spmm_tiles_plain(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                     cfg: SpmvConfig, F: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the SpMM kernel (``_resident_spmm_kernel``
    for fp32): ``xt`` is build_xt_multi's (n_parts, CT, 128, 128, Fp);
    returns the (F, n_blocks*S, 128) accumulators of its first F features
    (all Fp by default).  The routing is decoded once and the features run
    one after another, each folded in stream order."""
    check_float(cfg, "matmul")
    return _accumulate_runs(vals, idxT, tile_part, cmap, run_start, run_end,
                            xt, xt.shape[4] if F is None else F, cfg)


def _check_operands(name, vals, checks, cfg: SpmvConfig,
                    aligned=()) -> None:
    """Raise ``ValueError`` unless vals is (T, S, 128) with S % 128 == 0,
    of the pack's value dtype, and every (tensor, dtype, shape) of
    ``checks`` is on vals's device, of that dtype and shape, and
    contiguous; the tensors ``aligned`` must start on a 16-byte boundary
    (the kernel copies or loads them in 16-byte chunks)."""
    if vals.dim() != 3 or vals.shape[2] != LANES or vals.shape[1] % 128:
        raise ValueError(f"{name}: vals must be (T, S, {LANES}) with "
                         "S % 128 == 0")
    for t, dtype, shape in [(vals, VALUE_DTYPES[cfg.dtype],
                             vals.shape)] + checks:
        if t.device != vals.device:
            raise ValueError(f"{name}: operand on {t.device}, vals on "
                             f"{vals.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand not 16-byte aligned")


def _stream_checks(vals, idxT, tile_part, cmap, cfg: SpmvConfig):
    T, S, _ = vals.shape
    checks = [(idxT, torch.int16 if cfg.idx16 else torch.int32,
               (T, S, LANES)),
              (tile_part, torch.int32, (T,))]
    if cfg.block_major:
        checks.append((cmap, torch.int32, (T, S // 128,
                                           cfg.classes_per_group)))
    return checks


def _device_of(name, vals) -> str:
    """"cpu" for the plain version, "cuda" for the kernel; raise for any
    other device."""
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for {vals.device}")
    return vals.device.type


def _pack_kw(cfg: SpmvConfig) -> dict:
    """The pack's flags, as the ``_kernels.launch_*`` functions take
    them."""
    return dict(steal=cfg.steal_mantissa, block_major=cfg.block_major,
                n_ops=_n_ops(cfg), K=cfg.classes_per_group)


def _xt_check(xt, cfg: SpmvConfig):
    """The SpMV XT operand's check: (n_parts, CT, 128, 128) of the pack's
    x dtype."""
    return (xt, acc_dtype(cfg), (xt.shape[0], cfg.total_blocks, 128, 128))


def _run_checks(run_start, run_end):
    return [(run_start, torch.int32, run_start.shape),
            (run_end, torch.int32, run_start.shape)]


def wavepack_spmv(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                  cfg: SpmvConfig) -> torch.Tensor:
    """The tile stream -> the (n_blocks*S, 128) accumulator, in the pack's
    algebra (float32, or Q8.24 words in int32 for a Q8.24 pack).

    On CUDA tensors this launches ``csrc/wavepack_spmv.cu``; on CPU
    tensors it runs :func:`spmv_tiles_plain`.  Blocks without tiles come
    out at the semiring's identity.  The kernel trusts the values of its
    operands: runs from :func:`block_runs`, partition and class ids in
    range (``SpmvOperator`` checks both on the host when it is built);
    this wrapper checks device, dtype, shape and contiguity."""
    if _device_of("wavepack_spmv", vals) == "cpu":
        return spmv_tiles_plain(vals, idxT, tile_part, cmap, run_start,
                                run_end, xt, cfg)
    if run_start.dim() != 1:
        raise ValueError("wavepack_spmv: one run per block")
    _check_operands("wavepack_spmv", vals, _stream_checks(
        vals, idxT, tile_part, cmap, cfg) + _run_checks(run_start, run_end)
        + [_xt_check(xt, cfg)], cfg, aligned=(vals, idxT))
    out = torch.empty(run_start.shape[0] * vals.shape[1], LANES,
                      dtype=acc_dtype(cfg), device=vals.device)
    _kernels.launch_wavepack_spmv(
        vals, idxT, tile_part, cmap if cfg.block_major else None,
        run_start, run_end, xt, out, semiring=cfg.semiring, dtype=cfg.dtype,
        **_pack_kw(cfg))
    return out


def wavepack_spmv_masked(vals, idxT, tile_ids, tile_part, cmap, run_start,
                         run_end, xt, cfg: SpmvConfig) -> torch.Tensor:
    """The tiles ``tile_ids`` of the stream alone -> the (n_blocks*S, 128)
    accumulator, in the pack's semiring: the masked (SpMSpV) form of
    :func:`wavepack_spmv`.  ``tile_ids`` (int32, stream order) selects the
    tiles; ``run_start`` / ``run_end`` give each block's run into
    ``tile_ids`` (:func:`block_runs` of ``tile_block[tile_ids]``).  Tiles
    not selected are never read.

    On CUDA tensors this launches ``csrc/wavepack_spmv.cu``'s masked
    kernel; on CPU tensors it runs :func:`spmv_masked_tiles_plain`.  The
    kernel trusts tile ids and runs to be in range; this wrapper checks
    device, dtype, shape and contiguity.  Q8.24 packs raise
    ``ValueError``."""
    check_float(cfg, "the masked path")
    if _device_of("wavepack_spmv_masked", vals) == "cpu":
        return spmv_masked_tiles_plain(vals, idxT, tile_ids, tile_part,
                                       cmap, run_start, run_end, xt, cfg)
    if run_start.dim() != 1 or tile_ids.dim() != 1:
        raise ValueError("wavepack_spmv_masked: one run per block into a "
                         "1-D tile_ids")
    _check_operands("wavepack_spmv_masked", vals, _stream_checks(
        vals, idxT, tile_part, cmap, cfg) + _run_checks(run_start, run_end)
        + [(tile_ids, torch.int32, tile_ids.shape), _xt_check(xt, cfg)],
        cfg, aligned=(vals, idxT))
    out = torch.empty(run_start.shape[0] * vals.shape[1], LANES,
                      dtype=torch.float32, device=vals.device)
    _kernels.launch_wavepack_spmv_masked(
        vals, idxT, tile_ids, tile_part, cmap if cfg.block_major else None,
        run_start, run_end, xt, out, semiring=cfg.semiring, dtype=cfg.dtype,
        **_pack_kw(cfg))
    return out


def wavepack_gradstream(vals, idxT, mask, tile_part, tile_block, cmap,
                        g_acc, xt, cfg: SpmvConfig) -> torch.Tensor:
    """dL/dvals in the stream layout (T, S, 128): ``g_acc`` is the output
    cotangent broadcast to the (n_blocks*S, 128) accumulator geometry
    (``ops/train_stream.bcast_to_acc``), ``mask`` the 0/1 real-slot
    stream, ``xt`` the bank blocks of the forward's x.

    On CUDA tensors this launches ``csrc/wavepack_gradstream.cu``; on CPU
    tensors it runs :func:`gradstream_tiles_plain`.  The kernel trusts
    block, partition and class ids to be in range; this wrapper checks
    device, dtype, shape and contiguity."""
    check_plus_times(cfg, "the gradient stream")
    if _device_of("wavepack_gradstream", vals) == "cpu":
        return gradstream_tiles_plain(vals, idxT, mask, tile_part,
                                      tile_block, cmap, g_acc, xt, cfg)
    T, S, _ = vals.shape
    if g_acc.dim() != 2 or g_acc.shape[0] % max(S, 1):
        raise ValueError("wavepack_gradstream: g_acc must be "
                         "(n_blocks*S, 128)")
    _check_operands("wavepack_gradstream", vals, _stream_checks(
        vals, idxT, tile_part, cmap, cfg) + [
        (mask, torch.float32, (T, S, LANES)),
        (tile_block, torch.int32, (T,)),
        (g_acc, torch.float32, (g_acc.shape[0], LANES)),
        _xt_check(xt, cfg)], cfg, aligned=(vals, idxT, mask, g_acc))
    out = torch.empty_like(vals)
    if T:
        _kernels.launch_wavepack_gradstream(
            vals, idxT, mask, tile_part, tile_block,
            cmap if cfg.block_major else None, g_acc, xt, out,
            **_pack_kw(cfg))
    return out


def wavepack_spmm(vals, idxT, tile_part, cmap, run_start, run_end, xt,
                  cfg: SpmvConfig, F: int | None = None) -> torch.Tensor:
    """The tile stream -> the (F, n_blocks*S, 128) accumulators of the
    first F features of ``xt``, build_xt_multi's (n_parts, CT, 128, 128,
    Fp) with Fp a multiple of 4 up to ``SPMM_MAX_F`` (F = Fp by default).

    On CUDA tensors this launches ``csrc/wavepack_spmv.cu`` (the SpMV
    kernel's body with F accumulators); on CPU tensors it runs
    :func:`spmm_tiles_plain`.  The operand contract is
    :func:`wavepack_spmv`'s; Q8.24 packs raise ``ValueError``."""
    check_float(cfg, "matmul")
    if _device_of("wavepack_spmm", vals) == "cpu":
        return spmm_tiles_plain(vals, idxT, tile_part, cmap, run_start,
                                run_end, xt, cfg, F)
    Fp = xt.shape[-1]
    F = Fp if F is None else F
    if run_start.dim() != 1 or xt.dim() != 5 or Fp % 4 or not (
            1 <= F <= Fp <= SPMM_MAX_F):
        raise ValueError("wavepack_spmm: one run per block and an xt of "
                         "(n_parts, CT, 128, 128, Fp), Fp a multiple of 4, "
                         f"1 <= F <= Fp <= {SPMM_MAX_F}")
    _check_operands("wavepack_spmm", vals, _stream_checks(
        vals, idxT, tile_part, cmap, cfg) + _run_checks(run_start, run_end)
        + [(xt, torch.float32, (xt.shape[0], cfg.total_blocks, 128, 128,
                                Fp))], cfg, aligned=(vals, idxT, xt))
    out = torch.empty(F, run_start.shape[0] * vals.shape[1], LANES,
                      dtype=torch.float32, device=vals.device)
    _kernels.launch_wavepack_spmm(
        vals, idxT, tile_part, cmap if cfg.block_major else None,
        run_start, run_end, xt, out, semiring=cfg.semiring, dtype=cfg.dtype,
        **_pack_kw(cfg))
    return out


def stripe_fold(acc: torch.Tensor, cfg: SpmvConfig,
                n_blocks: int) -> torch.Tensor:
    """(n_blocks*S, 128) accumulator -> (n_blocks, R, 128) rows: the S/R
    sublanes of stripe sigma fold into row sigma (PE output stage), by
    sum, min or max as the semiring adds; a Q8.24 pack by the saturating
    sum ``fixed_sat_sum``, which for nonnegative terms is min(sum,
    FIX_MAX) in any order."""
    S, R = cfg.sublanes, cfg.stripes
    rows = acc.reshape(n_blocks, S // R, R, LANES)
    if cfg.dtype == "fixed":
        return _to_words(torch.clamp_max(_u32(rows).sum(dim=1), FIX_MAX))
    if cfg.semiring == "min_plus":
        return rows.amin(dim=1)
    if cfg.semiring == "max_times":
        return rows.amax(dim=1)
    return rows.sum(dim=1)


def fold_plan(perm, num_rows: int):
    """The fixed-order fold from renamed to natural rows of a pack whose
    renamed position i holds a partial of natural row ``perm[i]`` (padding
    positions hold ``num_rows``): the valid positions, stably sorted by
    natural row, as ``(idx, ptr, long_rows)``, int32 arrays.  Row r's
    partials are ``idx[ptr[r]:ptr[r+1]]``, in ascending renamed order;
    ``long_rows`` are the rows of more than ``FOLD_THREAD_MAX`` partials,
    which the kernel gives a warp each."""
    perm = np.asarray(perm)
    if perm.size >= 1 << 31:
        raise ValueError("the fold takes fewer than 2^31 renamed rows")
    valid = np.flatnonzero(perm < num_rows)
    rows = perm[valid]
    idx = valid[np.argsort(rows, kind="stable")].astype(np.int32)
    ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=num_rows), out=ptr[1:])
    long_rows = np.flatnonzero(np.diff(ptr) > FOLD_THREAD_MAX)
    return idx, ptr.astype(np.int32), long_rows.astype(np.int32)


def fold_add(acc, t, alg: str):
    """``acc (+) t`` as the fold adds a partial, the ufunc of
    ``Wavepack.unpack_y``: ``acc + t`` (plus_times; Q8.24 in int64),
    ``np.minimum`` or ``np.maximum``.  Those two keep a NaN from either
    side and, on a tie, take the new partial, as numpy's do, so signed
    zeros land where ``unpack_y`` puts them."""
    if alg == "min_plus":
        return torch.where((acc < t) | torch.isnan(acc), acc, t)
    if alg == "max_times":
        return torch.where((acc > t) | torch.isnan(acc), acc, t)
    return acc + t


def row_fold_plain(y, idx, ptr, alg: str) -> torch.Tensor:
    """Plain PyTorch version of the fold kernel: ``out[..., r]`` = the
    ``alg`` fold (:func:`fold_add`) of ``y[..., idx[j]]`` for j from
    ``ptr[r]`` to ``ptr[r+1] - 1`` in ascending order, from the identity;
    max_times then clamps at 0 (``np.maximum(out, 0)``, empty rows 0), a
    Q8.24 sum (``alg == "fixed"``, int32-carried words) at ``FIX_MAX``.
    ``y`` is (n_renamed,) or (F, n_renamed); returns (n_rows,) or (F,
    n_rows), float32 or Q8.24 words in int32."""
    n = ptr.shape[0] - 1
    starts = ptr[:-1].long()
    lengths = ptr[1:].long() - starts
    vals = _u32(y) if alg == "fixed" else y
    acc = torch.full(y.shape[:-1] + (n,), IDENTITY[alg], dtype=vals.dtype,
                     device=y.device)
    idx = idx.long()
    # rows by falling length: the rows still folding at step k are a prefix
    order = torch.argsort(lengths, descending=True, stable=True)
    hist = np.bincount(lengths.cpu().numpy(), minlength=1)
    longer = n - np.cumsum(hist)           # rows of more than k partials
    for k in range(hist.size - 1):
        live = order[:int(longer[k])]
        acc[..., live] = fold_add(acc[..., live],
                                  vals[..., idx[starts[live] + k]], alg)
    if alg == "fixed":
        return _to_words(torch.clamp_max(acc, FIX_MAX))
    if alg == "max_times":
        acc = torch.where((acc > 0) | torch.isnan(acc), acc,
                          torch.zeros_like(acc))
    return acc


def row_fold(y, idx, ptr, long_rows, alg: str) -> torch.Tensor:
    """Renamed -> natural rows: the fold of :func:`row_fold_plain`, the
    same bits, with ``(idx, ptr, long_rows)`` from :func:`fold_plan`.

    On CUDA tensors this launches ``csrc/row_fold.cu``; on CPU tensors it
    runs :func:`row_fold_plain`.  The kernel trusts the plan to index y;
    this wrapper checks device, dtype, shape and contiguity."""
    if _device_of("row_fold", y) == "cpu":
        return row_fold_plain(y, idx, ptr, alg)
    dtype = torch.int32 if alg == "fixed" else torch.float32
    if y.dim() not in (1, 2) or y.dtype != dtype or not y.is_contiguous():
        raise ValueError(f"row_fold: y must be a contiguous (n,) or (F, n) "
                         f"{dtype} tensor, got {tuple(y.shape)} {y.dtype}")
    for t in (idx, ptr, long_rows):
        if (t.device != y.device or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError("row_fold: idx, ptr and long_rows must be "
                             "contiguous 1-D int32 tensors on y's device")
    n = ptr.shape[0] - 1
    out = torch.empty(y.shape[:-1] + (n,), dtype=dtype, device=y.device)
    if out.numel():
        _kernels.launch_row_fold(y, idx, ptr, long_rows, out, alg=alg,
                                 thread_max=FOLD_THREAD_MAX)
    return out


class SpmvOperator(torch.nn.Module):
    """Device-resident packed matrix + SpMV, SpMM and masked SpMV (the
    port of ``hisparse_tpu.ops.spmv.SpmvOperator``).

    Construct once from a :class:`Wavepack` on a device (the card unless
    the caller asks for the CPU), then call with dense vectors.
    ``forward(x)`` returns y in natural row order as a tensor on the
    operator's device; ``renamed=True`` returns the packed row order.  With
    a pack ``col_order``, x is given in natural column order and permuted
    on the device (``permute_x=False`` when the caller already feeds
    packed-order x).  ``matmul(X)`` is the multi-vector form, ``masked(x,
    active)`` the sparse-frontier form.

    A Q8.24 pack takes x as Q8.24 words (a uint32 array, or floats that
    are quantized first) and its y comes back from the host recombine as a
    uint32 CPU tensor (renamed y: the device words, viewed as uint32)."""

    def __init__(self, wp: Wavepack, device="cuda", permute_x: bool = True):
        super().__init__()
        cfg = wp.config
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

        # bf16 values arrive as their uint16 bit patterns and stay 2 B on
        # the device; Q8.24 words ride in int32
        if cfg.dtype == "bf16":
            vals = buf(wp.vals, np.uint16).view(torch.bfloat16)
        elif cfg.dtype == "fixed":
            vals = buf(np.ascontiguousarray(wp.vals, np.uint32).view(
                np.int32))
        else:
            vals = buf(wp.vals, np.float32)
        self.register_buffer("vals", vals)
        self.register_buffer(
            "idxT", buf(wp.idxT, np.int16 if cfg.idx16 else np.int32))
        self.register_buffer("tile_part", buf(part, np.int32))
        self.register_buffer("tile_block", buf(wp.tile_block, np.int32))
        self.register_buffer(
            "class_map", buf(cmap) if cmap is not None else None)
        self.register_buffer("run_start", buf(start))
        self.register_buffer("run_end", buf(end))
        self.register_buffer("perm", buf(wp.perm, np.int64))
        # the fixed-order renamed -> natural fold (unpack_device)
        fold_idx, fold_ptr, fold_long = fold_plan(wp.perm, wp.num_rows)
        self.register_buffer("fold_idx", buf(fold_idx))
        self.register_buffer("fold_ptr", buf(fold_ptr))
        self.register_buffer("fold_long", buf(fold_long))
        permute = permute_x and wp.col_order is not None
        self.register_buffer(
            "col_order", buf(wp.col_order, np.int64) if permute else None)
        # natural column -> packed column, for the masked call's selection
        self._col_rank = None
        if permute:
            self._col_rank = np.empty(wp.num_cols, np.int64)
            self._col_rank[np.asarray(wp.col_order)] = np.arange(wp.num_cols)

    def stream_args(self, x: torch.Tensor, vals=None):
        """The operands of :func:`wavepack_spmv` for packed-order x, with
        ``vals`` (a stream of the pack's shape) in place of the stored
        values if given."""
        xt = build_xt(x, self.cfg, self.wp.n_parts)
        return (self.vals if vals is None else vals, self.idxT,
                self.tile_part, self.class_map, self.run_start, self.run_end,
                xt)

    def renamed_y(self, acc: torch.Tensor) -> torch.Tensor:
        """Accumulator -> y in packed (renamed) row order."""
        return stripe_fold(acc, self.cfg, self.wp.n_blocks).reshape(-1)

    def unpack_device(self, y_renamed: torch.Tensor) -> torch.Tensor:
        """Renamed -> natural-row-order y on the device: each row's
        hub-split partials fold in ascending renamed order from the
        semiring's identity (:func:`row_fold`), so the result has the
        same bits every run and on every device, those of
        ``Wavepack.unpack_y``; padding rows are dropped.  max_times rows
        with no term come out at 0, not -inf (``max(out, 0)``, the JAX
        package's clamp).  A (F, renamed) input gives (F, num_rows).
        Q8.24 packs raise ``ValueError``, as the JAX package's
        ``unpack_device`` does; their ``forward`` folds with
        :meth:`fold`."""
        if self.cfg.dtype == "fixed":
            raise ValueError("fixed-point recombine saturates; use "
                             "wp.unpack_y on host")
        return self.fold(y_renamed)

    def fold(self, y_renamed: torch.Tensor) -> torch.Tensor:
        """The fold of :meth:`unpack_device` in the pack's algebra, Q8.24
        (int32-carried words, a sum clamped at ``FIX_MAX``) included."""
        if y_renamed.shape[-1] != self.perm.shape[0]:
            raise ValueError(f"y has {y_renamed.shape[-1]} renamed rows, "
                             f"the pack {self.perm.shape[0]}")
        return row_fold(y_renamed.contiguous(), self.fold_idx, self.fold_ptr,
                        self.fold_long, algebra(self.cfg))

    def _x(self, x) -> torch.Tensor:
        if self.cfg.dtype == "fixed":
            x = fixed_bits(x).to(self.device)
        x = torch.as_tensor(x, device=self.device)
        if x.shape != (self.wp.num_cols,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.wp.num_cols},)")
        return x if self.col_order is None else x[self.col_order]

    def forward(self, x, renamed: bool = False, vals=None) -> torch.Tensor:
        """y = A x; ``vals`` (a stream of the pack's shape) replaces the
        stored values for this call, as the training paths do.  A Q8.24
        pack folds its words on the device (the saturating sum of
        ``Wavepack.unpack_y``, the JAX operator's host recombine) and
        returns them in one copy, as a uint32 CPU tensor."""
        acc = wavepack_spmv(*self.stream_args(self._x(x), vals), self.cfg)
        y = self.renamed_y(acc)
        if self.cfg.dtype == "fixed":
            if renamed:
                return y.view(torch.uint32)
            return self.fold(y).cpu().view(torch.uint32)
        return y if renamed else self.unpack_device(y)

    def active_tiles(self, active) -> np.ndarray:
        """The tiles, in stream order, that can touch an active column
        (``active_groups`` at tile granularity): a select-chain tile when
        its partition holds an active column (every block of the partition
        is a gather operand), a block-major tile when one of its groups'
        (partition, class) pairs does.  Two-choice second-copy classes
        re-bank columns across classes and count as active.  ``active`` is
        a bool mask or an index array over the packed column space."""
        cfg, wp = self.cfg, self.wp
        ac = np.asarray(active)
        if ac.dtype == np.bool_:
            ac = np.flatnonzero(ac)
        p = ac // cfg.vb_cols
        part = np.asarray(wp.tile_part)
        if cfg.block_major:
            act = np.zeros((wp.n_parts, cfg.total_blocks), bool)
            act[p, (ac % cfg.vb_cols) // (128 * LANES)] = True
            if cfg.two_choice:
                act[:, cfg.bank_blocks:] = True
            tile_act = act[part[:, None, None], wp.class_map]
            tile_act = tile_act.reshape(wp.num_tiles, -1).any(axis=1)
        else:
            act = np.zeros(wp.n_parts, bool)
            act[p] = True
            tile_act = act[part]
        return np.flatnonzero(tile_act)

    def masked(self, x, active, renamed: bool = False) -> torch.Tensor:
        """SpMSpV analog: y = A x from only the tiles that can touch an
        active column (:meth:`active_tiles`); the others are never read.
        Right whenever x holds the semiring's annihilator outside
        ``active`` (0 for plus_times, +inf for min_plus, 0 for max_times
        over nonnegative data, the apps' convention).  ``x`` and
        ``active`` (a bool mask or column ids, a numpy array or a tensor)
        are in natural column order, mapped through the pack's
        ``col_order`` as :meth:`forward` maps x.  Row blocks that no
        selected tile reaches come out at the semiring's identity in
        renamed order.  Q8.24 packs raise ``ValueError``."""
        check_float(self.cfg, "the masked path")
        x = self._x(x)
        if isinstance(active, torch.Tensor):
            active = active.cpu().numpy()
        ac = np.asarray(active)
        if ac.dtype == np.bool_:
            ac = np.flatnonzero(ac)
        if self._col_rank is not None:
            ac = self._col_rank[ac]
        return self.masked_tiles(x, self.active_tiles(ac), renamed)

    def masked_args(self, x: torch.Tensor, tiles):
        """The operands of :func:`wavepack_spmv_masked` for packed-order x
        and the stream's ``tiles`` (ascending tile ids, as
        :meth:`active_tiles` gives them): the ids and each block's run
        into them (:func:`block_runs`), on the operator's device."""
        tiles = np.asarray(tiles, np.int64)
        if tiles.size and (tiles[0] < 0 or tiles[-1] >= self.wp.num_tiles
                           or (np.diff(tiles) <= 0).any()):
            raise ValueError("tiles must be ascending tile ids in "
                             f"[0, {self.wp.num_tiles})")
        start, end = block_runs(np.asarray(self.wp.tile_block)[tiles],
                                self.wp.n_blocks)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                self.device)

        return (self.vals, self.idxT, dev(tiles), self.tile_part,
                self.class_map, dev(start), dev(end),
                build_xt(x, self.cfg, self.wp.n_parts))

    def masked_tiles(self, x: torch.Tensor, tiles,
                     renamed: bool = False) -> torch.Tensor:
        """The masked call's device half: y from the stream's ``tiles``
        alone, for packed-order x (:meth:`masked_args`)."""
        acc = wavepack_spmv_masked(*self.masked_args(x, tiles), self.cfg)
        y = self.renamed_y(acc)
        return y if renamed else self.unpack_device(y)

    def matmul(self, X, renamed: bool = False) -> torch.Tensor:
        """Multi-vector SpMM ``Y = A @ X`` through the packed stream
        (X: (num_cols, F) features, natural column order; returns
        (num_rows, F), or (F, renamed rows) with ``renamed=True``).  Each
        launch takes up to ``SPMM_MAX_F`` features and streams the matrix
        once for all of them.  Q8.24 packs raise ``ValueError``."""
        check_float(self.cfg, "matmul")
        X = torch.as_tensor(X, device=self.device)
        if X.dim() != 2 or X.shape[0] != self.wp.num_cols or X.shape[1] < 1:
            raise ValueError(f"matmul takes (num_cols, F) features with "
                             f"num_cols = {self.wp.num_cols}, got "
                             f"{tuple(X.shape)}")
        if self.col_order is not None:
            X = X[self.col_order]
        outs = []
        for f0 in range(0, X.shape[1], SPMM_MAX_F):
            Xc = X[:, f0:f0 + SPMM_MAX_F]
            fc = Xc.shape[1]
            acc = wavepack_spmm(self.vals, self.idxT, self.tile_part,
                                self.class_map, self.run_start,
                                self.run_end,
                                build_xt_multi(Xc, self.cfg, self.wp.n_parts),
                                self.cfg, F=fc)
            outs.append(stripe_fold(acc.reshape(-1, LANES), self.cfg,
                                    fc * self.wp.n_blocks).reshape(fc, -1))
        y_ren = torch.cat(outs)
        return y_ren if renamed else self.unpack_device(y_ren).T


def spmv(wp: Wavepack, x, device="cuda") -> torch.Tensor:
    """One-shot SpMV y = A @ x from a packed matrix."""
    return SpmvOperator(wp, device=device)(x)


def spmm(wp: Wavepack, X, device="cuda") -> torch.Tensor:
    """One-shot SpMM Y = A @ X (X: (num_cols, F)) from a packed matrix;
    see :meth:`SpmvOperator.matmul`."""
    return SpmvOperator(wp, device=device).matmul(X)
