"""Wavepack — the TPU-native successor of the reference's CPSR format.

This module is a copy of ``hisparse_tpu/formats/wavepack.py``: the port
reads the same bytes, and ``tests/test_torch_formats.py`` pins its
``pack()`` and ``pack_hybrid()`` byte-equal to the JAX package's.  The
format notes below speak of the TPU's lanes and sublanes; on the GPU they are
plain array axes of the stream (see ``ops/spmv.py``).

The reference turns SpMV into fully-sequential HBM streams with a custom
format (CPSR: ``csr2cpsr``, sw/data_formatter.h:465-544) and resolves the
x-gather / y-scatter conflicts **at run time** with an arbitrated 8x8
crossbar ("shuffler", spmv/libfpga/shuffle.h:211-377) and stall-free PEs
(spmv/libfpga/pe.h:22-90).  A TPU has no arbitrated crossbar, but its VPU
has a *static* per-sublane 128-lane crossbar (``tpu.dynamic_gather`` along
lanes).  Wavepack therefore moves the entire arbitration into the
preprocessor: nonzeros are scheduled into conflict-free "waves" offline, so
the kernel executes pure data-independent vector ops at line rate.

Format geometry (see config.SpmvConfig):

  * A **wave** is one sublane of a streamed (S, 128) tile: 128 slots.
  * **Gather slot** (w, j): lane j is the *column bank*; the nonzero placed
    there must have ``col % 128 == j``.  Its in-bank address
    ``a = col//128`` splits into source block ``b = a//128`` and offset
    ``h = a%128``; the kernel gathers ``x_bank[a, j]`` with one lane-gather
    per (128-sublane group, block) from a pre-transposed x tile.
    This is the analog of the banked vector buffer + col-shuffle
    (vecbuf_access_unit.h:18-84, shuffle keyed on col shuffle.h:24-99).
  * **Dest slot** (w, lam): lane lam is the *row lane*.  Renamed rows are
    dealt round-robin over stripes (``sigma = rho % R``, ``lam = rho // R``
    within a block) so nnz-sorted rows spread evenly and every stripe's
    wave demand is balanced; a wave at sublane s hosts stripe ``s % R``.
    Products are routed gather-slot -> dest-slot by a second lane-gather
    (the analog of the row-shuffle, shuffle.h:102-177) and accumulated into
    a resident (S,128) accumulator; a block flush reduces sublanes
    ``s = sigma mod R`` into the (R,128) output tile (the PE output stage,
    pe.h:95-116).
  * Rows are renamed by descending nnz before assignment (the load-balance
    reordering the reference ships but leaves unused,
    data_formatter.h:337-368 — here it is load-bearing).
  * Tiles stream per (row block, column partition), the analog of the
    row/col partition loops (sw/host.cpp:335-357, spmv_vector_loader.cpp:22-68).

Scheduling constraints per wave (all enforced here, offline):
  1. at most one nonzero per gather slot  (distinct banks)
  2. at most one nonzero per dest slot    (distinct row lanes)
  3. wave sublane s only hosts rows of stripe ``s % R``

Stream encoding per tile:
  * ``vals``  (S,128) value dtype, at DEST slots (multiply happens after the
    row-crossbar).  Padding slots hold 0.
  * ``idxT``  (S,128) int32, holding for slot (s,j) the packed fields
    ``src(7) << 11 | b(4) << 7 | h(7)`` **stored at the per-group transposed
    position** (g*128 + j, s mod 128 ...) so the kernel's gathers consume
    them without an extra transpose.  ``h``/``b`` describe the slot's
    gather role; ``src`` describes its dest role (which gather lane feeds
    this dest slot).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import LANES, SpmvConfig
from .csr import CSRMatrix, argsort_rows_by_nnz

# Rolling-window defaults for the block-major scheduler: BM_WIN in-flight
# tiles per pending-list pass, advancing BM_ADV tiles per pass (every tile
# gets BM_WIN/BM_ADV dedicated passes).  A per-pack speed/fill tradeoff:
# larger windows amortize list traversals; smaller advances give later
# tiles fresher class selections (higher fill, more passes).  pack()
# resolves (arg > WP_BMWIN/WP_BMADV env > these defaults) and passes the
# SAME values to both scheduler twins, keeping them byte-equal.
BM_WIN = 16
BM_ADV = 4


def bank_shift(b: int):
    """Per-block lane rotation of the second-choice x copy (two-choice
    banking).  Any fixed nonzero shift sequence works; this one decorrelates
    neighboring blocks."""
    return (b * 61 + 17) % 127 + 1


def f32_to_bf16_bits(v) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even
    from the float32 bits: ties go to the even mantissa, values past the
    largest bf16 round to inf, subnormals round like any other value, and a
    NaN becomes the quiet NaN of its sign (0x7FC0 | sign), as ``ml_dtypes``
    converts.  The port carries bf16 streams as these bits, so it needs no
    bf16 dtype in numpy; other float dtypes are rounded to float32 first."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    out = np.where(nan, (bits >> 16) & np.uint32(0x8000) | np.uint32(0x7FC0),
                   rounded)
    return out.astype(np.uint16)


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


@dataclasses.dataclass
class Wavepack:
    """A packed matrix: streams + schedule metadata (CPSRMatrix analog,
    data_formatter.h:195-238)."""

    config: SpmvConfig
    num_rows: int              # original (unpadded) dims
    num_cols: int
    n_blocks: int
    n_parts: int
    perm: np.ndarray           # (n_blocks*R*128,) renamed -> original row id;
                               #  several renamed rows may map to one original
                               #  (hub splitting) and must be summed; entries
                               #  == num_rows are padding rows
    vals: np.ndarray           # (T, S, 128) float32 / uint32 (fixed) /
                               #  uint16 bf16 bit patterns (bf16)
    idxT: np.ndarray           # (T, S, 128) int32, transposed-layout fields
    tile_part: np.ndarray      # (T,) int32  column partition of each tile
    tile_block: np.ndarray     # (T,) int32  row block of each tile
    tile_first: np.ndarray     # (T,) int32  1 on the first tile of a block
    tile_last: np.ndarray      # (T,) int32  1 on the last tile of a block
    nnz: int
    col_order: np.ndarray | None = None   # new col i = original col_order[i]
    class_map: np.ndarray | None = None   # (T, S//128, K) int32, block-major
    opt_waves: int = 0         # edge-coloring schedule lower bound (waves)

    @property
    def num_tiles(self) -> int:
        return self.vals.shape[0]

    @property
    def alpha(self) -> float:
        """Measured schedule efficiency: optimum waves / scheduled waves.

        The optimum is the exact per-(segment, stripe) bipartite
        edge-coloring lower bound max(max per-lane nonzeros, max per-bank
        distinct columns), computed by the packer — the analog of the
        reference's instrumented-csim iteration counts
        (performance_model/include/shuffle.h:199,279).  Block-major packs
        trade alpha for per-group gather count; the gap is the class
        constraint's cost."""
        sched = self.num_tiles * self.config.sublanes
        return min(1.0, self.opt_waves / sched) if sched else 1.0

    @property
    def fill(self) -> float:
        """Slot occupancy — the analog of the reference's beta padding ratio
        (performance_model.cpp:430-444)."""
        return self.nnz / max(self.num_tiles * self.config.tile_slots, 1)

    @property
    def stream_bytes(self) -> int:
        return self.vals.nbytes + self.idxT.nbytes

    def unpack_y(self, y_renamed: np.ndarray) -> np.ndarray:
        """Fold a renamed-space result back to original row order, combining
        virtual-row partials with the semiring's additive op (the combine
        step of hub splitting)."""
        sr = self.config.semiring
        valid = self.perm < self.num_rows
        if self.config.dtype == "fixed":
            # saturating unsigned recombine: for nonnegative terms the
            # order-independent closed form of repeated ap_ufixed AP_SAT
            # adds is min(true sum, 2^32-1)
            acc = np.zeros(self.num_rows, np.uint64)
            np.add.at(acc, self.perm[valid],
                      y_renamed[valid].astype(np.uint64))
            return np.minimum(acc, np.uint64(0xFFFFFFFF)).astype(np.uint32)
        init = {"plus_times": 0.0, "min_plus": np.inf,
                "max_times": -np.inf}[sr]
        ufunc = {"plus_times": np.add, "min_plus": np.minimum,
                 "max_times": np.maximum}[sr]
        out = np.full(self.num_rows, init, y_renamed.dtype)
        ufunc.at(out, self.perm[valid], y_renamed[valid])
        if sr == "max_times":
            out = np.maximum(out, 0.0)   # empty rows -> 0
        return out


def _schedule_segments(seg_bounds: np.ndarray, stripe: np.ndarray,
                       lam: np.ndarray, bank: np.ndarray,
                       addr: np.ndarray, bank2: np.ndarray | None):
    """Schedule every (block, part) segment (pure-Python twin of the fused
    native pipeline; pack() calls native.pack_full at dataset scale).
    Returns (k_of, choice) where choice[i]=1 means the nonzero's gather slot
    uses its second-choice bank."""
    if bank2 is None:
        bank2 = bank
    k_of = np.empty(stripe.size, np.int64)
    choice = np.zeros(stripe.size, np.uint8)
    for i in range(seg_bounds.size - 1):
        s, e = int(seg_bounds[i]), int(seg_bounds[i + 1])
        k_of[s:e], choice[s:e] = _schedule(stripe[s:e], lam[s:e], bank[s:e],
                                           addr[s:e], bank2[s:e])
    return k_of, choice


def _schedule(sigma: np.ndarray, lam: np.ndarray, bank: np.ndarray,
              addr: np.ndarray, bank2: np.ndarray | None = None):
    """Assign each nonzero a wave index k within its stripe.

    Constraints per (stripe, k):
      * each row lane holds at most one nonzero (dest slot), and
      * each column bank serves at most one **distinct column** (gather
        slot) — nonzeros sharing a column share one gather slot, because the
        row-crossbar is a gather and duplicate pulls are free.  This is the
        TPU upgrade over the reference's arbiter (shuffle.h:24-99), which
        must serialize same-bank traffic even for one hot column; here a hub
        column broadcasts to up to 128 rows per wave.

    Wave-batched first-fit-decreasing (the round-4 rewrite, same batching
    the block-major scheduler uses): items (distinct columns) are visited
    ONCE per 64-wave window in descending row-count order (the offline
    analog of the rotating-priority arbiter) and place each free row into
    the lowest window wave where (a) the item's bank is unclaimed or
    already claimed by this item, and (b) the row lane is free — tracked
    by per-lane / per-bank 64-bit wave masks.  One pass per window is
    complete (masks only grow, so a row that fails a pass fails the
    window), and a window opens only when every wave of the previous one
    is nonempty, so wave indices stay gap-free.  Replaces the per-wave
    cursor walk (with its fruitless-visit cap) — ~W fewer list traversals
    at equal-or-better fill, since no placement is ever lost to the cap.
    Wave count per stripe approaches the optimum
    max(max row nnz, max per-bank distinct-column load).

    Pure-Python reference implementation; the C++ twin
    (_scheduler.cpp::schedule_chain_segment) runs the identical algorithm
    at dataset scale — change BOTH.
    """
    if bank2 is None:
        bank2 = bank
    k_of = np.empty(sigma.shape[0], np.int64)
    choice = np.zeros(sigma.shape[0], np.uint8)
    order = np.lexsort((np.arange(sigma.size), addr, bank, sigma))
    so = sigma[order]
    starts = np.flatnonzero(np.r_[True, so[1:] != so[:-1]])
    bounds = np.r_[starts, so.size]
    W = 64
    FULL = (1 << W) - 1
    for si in range(starts.size):
        lo_i, hi_i = bounds[si], bounds[si + 1]
        idxs = order[lo_i:hi_i]
        # group this stripe's nonzeros by column (bank, addr)
        items = {}
        for nz in idxs:
            key = (int(bank[nz]), int(addr[nz]))
            items.setdefault(key, []).append(nz)
        pending = [[key[0], int(bank2[v[0]]), v]
                   for key, v in items.items()]
        for ent in pending:
            ent[2].reverse()   # pop() yields CSR order
        pending.sort(key=lambda e: -len(e[2]))
        k_base = 0
        while pending:
            lane_mask = [0] * LANES        # per row lane: waves occupied
            bank_mask = [0] * LANES        # per bank: waves claimed
            nxt = []
            for ent in pending:            # one pass, desc count order
                bk1, bk2, q = ent
                m1 = m2 = 0                # waves THIS item claimed per bank
                kept = []
                while q:
                    nz = q.pop()
                    free = ~lane_mask[int(lam[nz])] & FULL
                    cand = (~bank_mask[bk1] | m1) & free
                    if cand:
                        ch = 0
                    else:
                        cand = (~bank_mask[bk2] | m2) & free
                        if not cand:
                            kept.append(nz)
                            continue
                        ch = 1
                    w = (cand & -cand).bit_length() - 1
                    bit = 1 << w
                    if ch:
                        m2 |= bit
                        bank_mask[bk2] |= bit
                    else:
                        m1 |= bit
                        bank_mask[bk1] |= bit
                    lane_mask[int(lam[nz])] |= bit
                    k_of[nz] = k_base + w
                    choice[nz] = ch
                if kept:
                    kept.reverse()         # restore pop-stack order
                    ent[2] = kept
                    nxt.append(ent)
            pending = nxt                  # stable compaction
            k_base += W
    return k_of, choice


def pack(m: CSRMatrix, config: SpmvConfig | None = None,
         row_order: np.ndarray | None = None,
         split_max: int | None | str = None,
         col_order: np.ndarray | str | None = None,
         bm_win: int | None = None, bm_adv: int | None = None,
         _stop_frac: float = 0.0,
         _leftover_out: dict | None = None) -> Wavepack:
    """Pack a CSR matrix into wavepack streams (csr2cpsr analog,
    data_formatter.h:465-544).

    split_max bounds per-row nonzeros by splitting hub rows into virtual
    rows whose partial sums are recombined at unpack time (perm then maps
    several renamed rows to the same original row).

    col_order optionally permutes columns at pack time (new col i reads
    original column col_order[i]); callers must then feed x permuted the
    same way.  With row_order == col_order on a square matrix this packs
    P A P^T, letting iterative algorithms (PageRank) chain y -> x entirely
    in the renamed device space — the graph-reordering trick.

    This is the numpy reference packer; `hisparse_tpu_torch.formats.native` holds
    the C++ production packer with identical output (validated against this
    one in tests).
    """
    from ..utils.tracing import log_phase, span
    import os as _os
    cfg = config or SpmvConfig()
    if bm_win is None:
        bm_win = int(_os.environ.get("WP_BMWIN", BM_WIN))
    if bm_adv is None:
        bm_adv = int(_os.environ.get("WP_BMADV", BM_ADV))
    bm_win = max(1, min(int(bm_win), 64))      # uint64 wave masks
    bm_adv = max(1, min(int(bm_adv), bm_win))
    log_phase(f"pack: {m.num_rows}x{m.num_cols} nnz={m.nnz} cfg={cfg}")
    with span("hisparse.pack.split"):
        if isinstance(col_order, str):
            if col_order != "degree":
                raise ValueError(f"unknown col_order preset {col_order!r}")
            from .csr import argsort_cols_by_degree
            col_order = argsort_cols_by_degree(m)
        orig_num_rows = m.num_rows
        if split_max == "auto":
            # bound hub rows near the mean so no single row dominates its
            # stripe's wave count (fill sweep: ~1x mean is the sweet spot;
            # round-to-nearest beats ceil on low-degree power-law graphs —
            # pokec-400k fill 0.20 -> 0.22, scratch/tpu_sweep_r2)
            mean = max(float(m.nnz) / max(m.num_rows, 1), 1.0)
            split_max = max(8, 1 << int(round(np.log2(mean))))
        if split_max is not None:
            from .csr import split_rows
            m, row_map = split_rows(m, split_max)
        else:
            row_map = np.arange(m.num_rows, dtype=np.int64)
    with span("hisparse.pack.rename"):
        S, R, B = cfg.sublanes, cfg.stripes, cfg.bank_blocks
        RPB = cfg.rows_per_block          # rows per block
        VB = cfg.vb_cols                  # cols per partition
        n_blocks = max(1, -(-m.num_rows // RPB))
        n_parts = max(1, -(-m.num_cols // VB))

        nnz_total = m.nnz
        if col_order is not None:
            col_rank = np.empty(m.num_cols, np.int64)
            col_rank[col_order] = np.arange(m.num_cols)
        else:
            col_rank = None

        # --- row renaming ---------------------------------------------------
        # default: sort by nnz descending (data_formatter.h:337-368), dealt
        # round-robin over blocks and stripes for balanced wave demand.
        # "locality": cluster rows by the mean degree-rank of their columns
        # and give each (block, stripe) a CONTIGUOUS 128-row cluster, so
        # every wave's rows want the same few x-blocks — the co-clustering
        # answer to class starvation on spread-column graphs (pokec-400k
        # fill 0.27 -> 0.35 measured; needs a col_order for the rank key).
        if isinstance(row_order, str):
            if row_order != "locality":
                raise ValueError(f"unknown row_order preset {row_order!r}")
            rows_of = np.repeat(np.arange(m.num_rows), m.row_nnz())
            cr = (col_rank[m.indices] if col_rank is not None
                  else m.indices.astype(np.int64))
            s = np.zeros(m.num_rows)
            np.add.at(s, rows_of, cr.astype(np.float64))
            key = np.full(n_blocks * RPB, np.inf)    # empty + pad rows last
            nr = m.row_nnz()
            key[:m.num_rows] = np.where(nr > 0, s / np.maximum(nr, 1), np.inf)
            order = np.argsort(key[:m.num_rows], kind="stable")
            order = np.concatenate([order, np.arange(m.num_rows,
                                                     n_blocks * RPB)])
            perm = np.empty(n_blocks * RPB, np.int64)
            nch = n_blocks * RPB // 128
            ci = np.arange(nch)
            # chunk ci -> block ci//R, stripe ci%R; lane lam within the chunk:
            # rank r = blk + n_blocks*(sigma + R*lam)
            r_base = (ci // R) + n_blocks * (ci % R)
            ranks = (r_base[:, None]
                     + (n_blocks * R) * np.arange(128)[None, :]).reshape(-1)
            perm[ranks] = order
        else:
            if row_order is None:
                row_order = argsort_rows_by_nnz(m, descending=True)
            perm = np.concatenate(
                [row_order,
                 np.arange(m.num_rows, n_blocks * RPB)]).astype(np.int64)

        # renamed id of each original row
        rank = np.empty(n_blocks * RPB, np.int64)
        rank[perm] = np.arange(n_blocks * RPB)
        if cfg.dtype == "fixed":
            val_dtype = m.data.dtype
        elif cfg.dtype == "bf16":
            val_dtype = np.dtype(np.uint16)        # bf16 bit patterns
        else:
            val_dtype = np.dtype(np.float32)

        def stream_values(data):
            return (f32_to_bf16_bits(data) if cfg.dtype == "bf16"
                    else np.ascontiguousarray(data, val_dtype))

        G = cfg.groups
        class_map = None

        from . import native
    with span("hisparse.pack.plan_emit"):
        idx_dtype = np.int16 if cfg.idx16 else np.int32
        if nnz_total == 0:
            pad0 = np.inf if cfg.semiring == "min_plus" else 0
            vals = np.full((1, S, LANES), pad0, val_dtype)
            idxT = np.zeros((1, S, LANES), idx_dtype)
            t_block_arr = np.zeros(1, np.int32)
            t_part_arr = np.zeros(1, np.int32)
            first = np.ones(1, np.int32)
            last = np.ones(1, np.int32)
            opt_waves = 0
        elif native.available() and (res := native.pack_full(
                m.indptr, m.indices, stream_values(m.data),
                rank, col_rank, cfg, n_blocks, n_parts,
                min_tile=int(_stop_frac * S * LANES),
                bm_win=bm_win, bm_adv=bm_adv)) is not None:
            # fused native pipeline (the production path; the branch below is
            # its byte-identical pure-Python twin)
            vals, idxT = res["vals"], res["idxT"]
            t_block_arr, t_part_arr = res["tile_block"], res["tile_part"]
            first, last = res["tile_first"], res["tile_last"]
            class_map = res["class_map"]
            if _leftover_out is not None:
                _leftover_out["nz"] = res["leftover"]
            nnz_total = res["nnz"]
            opt_waves = res["opt_waves"]
        else:
            row_of_nz = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
            rho_all = rank[row_of_nz]           # renamed row per nonzero
            if col_rank is not None:
                col_all = col_rank[m.indices]
            else:
                col_all = m.indices.astype(np.int64)
            part_all = (col_all // VB).astype(np.int32)
            c_in = col_all % VB
            bank_all = (c_in % LANES).astype(np.int32)  # gather lane j
            a_all = (c_in // LANES).astype(np.int32)    # in-bank address
            # rows dealt round-robin across blocks as well, so every block sees
            # the same nnz mix (the reference's cyclic channel assignment,
            # data_formatter.h:410, for the same reason)
            blk_of_nz = (rho_all % n_blocks).astype(np.int32)
            rho_loc = rho_all // n_blocks
            # round-robin stripe deal: consecutive (nnz-sorted) renamed rows go
            # to different stripes, balancing per-stripe wave demand
            sigma_all = (rho_loc % R).astype(np.int32)
            lam_all = (rho_loc // R).astype(np.int32)
            # one global sort — stable, so ties keep CSR order.  The
            # block-major path sorts by (block, part, stripe, class, bank, h)
            # so segment slices arrive in the scheduler's span order; the
            # select-chain path by (block, part, stripe, bank, addr).  Must
            # match the native pipeline's keys exactly
            # (_scheduler.cpp::wp_plan).
            amax = B * 128
            seg_all = blk_of_nz.astype(np.int64) * n_parts + part_all
            if cfg.block_major:
                key = ((((seg_all * R + sigma_all) * B + a_all // 128) * LANES
                        + bank_all) * 128 + a_all % 128)
            else:
                key = (((seg_all * R + sigma_all) * LANES + bank_all) * amax
                       + a_all)
            order = np.argsort(key, kind="stable")
            bo, po = blk_of_nz[order], part_all[order]
            so, lo = sigma_all[order], lam_all[order]
            jo, ao = bank_all[order], a_all[order]
            seg_key = bo.astype(np.int64) * n_parts + po
            seg_starts = np.flatnonzero(
                np.r_[True, seg_key[1:] != seg_key[:-1]])
            seg_bounds = np.r_[seg_starts, nnz_total]
            # captured before any leftover filtering re-indexes bo/po
            seg_block, seg_part = bo[seg_starts], po[seg_starts]

            if cfg.two_choice:
                blk_o = ao // 128
                shifts = np.array(
                    [bank_shift(b) for b in range(cfg.bank_blocks)], np.int32)
                b2o = ((jo + shifts[blk_o]) % LANES).astype(np.int32)
            else:
                b2o = None
            n_segs = seg_starts.size
            # exact schedule lower bound (see Wavepack.alpha), computed from
            # the pre-scheduling record set exactly like the native pipeline
            # (_scheduler.cpp::segment_opt_waves)
            seg_of_nz0 = np.repeat(np.arange(n_segs), np.diff(seg_bounds))
            cell = (seg_of_nz0 * R + so).astype(np.int64) * 128
            lane_cnt = np.bincount(cell + lo, minlength=n_segs * R * 128)
            item_start = np.r_[True, (so[1:] != so[:-1]) | (jo[1:] != jo[:-1])
                               | (ao[1:] != ao[:-1])
                               | (seg_of_nz0[1:] != seg_of_nz0[:-1])]
            bank_cnt = np.bincount(cell[item_start] + jo[item_start],
                                   minlength=n_segs * R * 128)
            opt_waves = int(np.maximum(lane_cnt.reshape(-1, 128).max(axis=1),
                                       bank_cnt.reshape(-1, 128).max(axis=1))
                            .sum())
            if cfg.block_major:
                CT = cfg.total_blocks
                cls_o = (ao // 128).astype(np.int32)
                if cfg.two_choice:
                    # cross-class second copy: class2 = B + (a mod B) holds
                    # the column at h2 = a // B with a per-second-class lane
                    # rotation — high/low address bits decorrelate the
                    # choices
                    B_ = cfg.bank_blocks
                    cls2_o = (B_ + ao % B_).astype(np.int32)
                    shifts2 = np.array([bank_shift(b) for b in range(B_)],
                                       np.int32)
                    b2x = ((jo + shifts2[ao % B_]) % LANES).astype(np.int32)
                else:
                    cls2_o = cls_o
                    b2x = jo
                t_glob = np.empty(nnz_total, np.int64)
                s_loc = np.empty(nnz_total, np.int64)
                lane_used = np.empty(nnz_total, np.int32)
                bsel = np.zeros(nnz_total, np.int32)
                choice = np.zeros(nnz_total, np.uint8)
                cmaps = []
                seg_tiles = np.empty(n_segs, np.int64)
                off = 0
                K = cfg.classes_per_group
                for i in range(n_segs):
                    a0, a1 = int(seg_bounds[i]), int(seg_bounds[i + 1])
                    sl = slice(a0, a1)
                    res = _schedule_block_major(
                        so[sl], lo[sl], jo[sl],
                        (ao[sl] % 128).astype(np.int32),
                        cls_o[sl], cls2_o[sl], b2x[sl], R, S, CT, K,
                        stop_frac=_stop_frac, bm_win=bm_win, bm_adv=bm_adv)
                    t_l, s_l, ln, bs, ch, cm = res
                    t_l = np.where(t_l < 0, np.int64(-10**9), t_l)
                    t_glob[sl] = t_l + off
                    s_loc[sl] = s_l
                    lane_used[sl] = ln
                    bsel[sl] = bs
                    choice[sl] = ch
                    cmaps.append(cm)
                    seg_tiles[i] = cm.shape[0]
                    off += cm.shape[0]
                class_map = np.concatenate(cmaps).astype(np.int32)
                T_total = int(off)
                placed_mask = t_glob >= 0
                if _leftover_out is not None:
                    _leftover_out["nz"] = order[np.nonzero(~placed_mask)[0]]
                if not placed_mask.all():
                    keepm = placed_mask
                    t_glob, s_loc = t_glob[keepm], s_loc[keepm]
                    lane_used, bsel = lane_used[keepm], bsel[keepm]
                    choice = choice[keepm]
                    bo, po = bo[keepm], po[keepm]
                    so, lo = so[keepm], lo[keepm]
                    jo, ao = jo[keepm], ao[keepm]
                    if b2o is not None:
                        b2o = b2o[keepm]
                    order = order[keepm]
                    nnz_total = int(keepm.sum())
            else:
                k_of, choice = _schedule_segments(seg_bounds, so, lo, jo, ao,
                                                  b2o)
                # per-segment tile counts and global tile offsets
                w = so.astype(np.int64) + k_of * R
                seg_tiles = np.empty(n_segs, np.int64)
                for i in range(n_segs):
                    wmax = int(w[seg_bounds[i]:seg_bounds[i + 1]].max())
                    seg_tiles[i] = wmax // S + 1
                tile_off = np.r_[0, np.cumsum(seg_tiles)]
                T_total = int(tile_off[-1])
                seg_of_nz = np.repeat(np.arange(n_segs), np.diff(seg_bounds))
                t_glob = tile_off[seg_of_nz] + w // S
                s_loc = (w % S).astype(np.int64)

            pad_val = (np.float32(np.inf) if cfg.semiring == "min_plus"
                       else val_dtype.type(0) if hasattr(val_dtype, "type")
                       else np.float32(0))
            vals_sorted = stream_values(m.data[order])
            if cfg.block_major:
                bfield = bsel
                if cfg.two_choice:
                    ha_field = np.where(choice, ao // cfg.bank_blocks,
                                        ao % 128).astype(np.int32)
                else:
                    ha_field = (ao % 128).astype(np.int32)
            elif cfg.two_choice:
                lane_used = np.where(choice, b2o, jo).astype(np.int32)
                bfield = (ao // 128
                          + cfg.bank_blocks * choice).astype(np.int32)
                ha_field = (ao % 128).astype(np.int32)
            else:
                lane_used = jo
                bfield = (ao // 128).astype(np.int32)
                ha_field = (ao % 128).astype(np.int32)
            va = np.full((T_total, S, LANES), pad_val, val_dtype)
            packed = np.zeros((T_total, S, LANES), idx_dtype)
            # gather-role fields at (t, s, gather lane); dest-role at
            # (t, s, row lane)
            packed[t_glob, s_loc, lane_used] |= (bfield << 7) | ha_field
            if cfg.steal_mantissa:
                # src lane rides in the 7 low mantissa bits of the value
                vbits = vals_sorted.view(np.uint32)
                va[t_glob, s_loc, lo] = ((vbits & np.uint32(0xFFFFFF80))
                                         | lane_used.astype(np.uint32)
                                         ).view(np.float32)
            else:
                packed[t_glob, s_loc, lo] |= lane_used << 11
                va[t_glob, s_loc, lo] = vals_sorted
            idxT = (packed.reshape(T_total, G, 128, 128)
                    .swapaxes(2, 3).reshape(T_total, S, LANES).copy())
            vals = va

            t_block_arr = np.repeat(seg_block, seg_tiles).astype(np.int32)
            t_part_arr = np.repeat(seg_part, seg_tiles).astype(np.int32)
            first = np.zeros(T_total, np.int32)
            last = np.zeros(T_total, np.int32)
            chg = np.r_[True, t_block_arr[1:] != t_block_arr[:-1]]
            first[chg] = 1
            last[np.r_[chg[1:], True]] = 1
    # map renamed -> original rows (virtual rows of a split hub all map to
    # the same original row; padding rows map to the sentinel orig_num_rows)
    perm_orig = np.where(perm < m.num_rows,
                         row_map[np.minimum(perm, max(m.num_rows - 1, 0))],
                         orig_num_rows)
    # re-store in y-layout: rank rho sits at y slot
    # (block = rho % n_blocks, sigma = (rho//n_blocks) % R,
    #  lam = (rho//n_blocks) // R)
    ranks = np.arange(n_blocks * RPB)
    bk_r = ranks % n_blocks
    loc_r = ranks // n_blocks
    yslot = bk_r * RPB + (loc_r % R) * LANES + loc_r // R
    perm_y = np.empty_like(perm_orig)
    perm_y[yslot] = perm_orig[ranks]
    perm_orig = perm_y
    if nnz_total == 0 and cfg.block_major:
        class_map = np.zeros((1, cfg.groups, cfg.classes_per_group),
                             np.int32)
    return Wavepack(cfg, orig_num_rows, m.num_cols, n_blocks, n_parts,
                    perm_orig, vals, idxT, t_part_arr, t_block_arr, first,
                    last, nnz=nnz_total, col_order=col_order,
                    class_map=class_map if cfg.block_major else None,
                    opt_waves=opt_waves)


def decode(wp: Wavepack) -> CSRMatrix:
    """Golden stream decoder — reconstruct the matrix the streams encode.

    The analog of the reference's csim as a *format* oracle
    (spmv_csim/csim.cpp:22-136): it exercises the encoding/schedule,
    catching packing bugs the math model cannot.  Nonzeros with value 0 are
    dropped on both sides of the comparison.
    """
    lin, rows, cols, vals = slot_coords(wp)
    import scipy.sparse as sp
    coo = sp.coo_matrix((vals, (rows, cols)),
                        shape=(max(wp.num_rows, 1), max(wp.num_cols, 1)))
    return CSRMatrix.from_scipy(coo.tocsr())


def slot_coords(wp: Wavepack):
    """Per-slot provenance of the emitted stream: ``(lin, rows, cols,
    vals)`` over every REAL (non-pad) slot, where ``lin = (t*S + s)*128 +
    lane`` is the slot's flat position in the ``(T, S, 128)`` stream and
    ``(row, col)`` are the ORIGINAL matrix coordinates the slot encodes.
    This is the decode() oracle's math with the slot position kept;
    ops/autodiff.py uses it to scatter CSR-order values/gradients into and
    out of the packed stream.  Pad slots are identified by the additive
    identity, so autodiff callers must canonicalize away explicit-zero
    nonzeros first."""
    cfg = wp.config
    S, R, G = cfg.sublanes, cfg.stripes, cfg.groups
    RPB, VB = cfg.rows_per_block, cfg.vb_cols
    lins, rows, cols, vals = [], [], [], []
    for t in range(wp.num_tiles):
        bk = int(wp.tile_block[t])
        p = int(wp.tile_part[t])
        packed = (wp.idxT[t].reshape(G, 128, 128)
                  .swapaxes(1, 2).reshape(S, LANES).astype(np.int64))
        h = packed & 0x7F
        b = (packed >> 7) & 0xF
        v = wp.vals[t]
        if cfg.dtype == "bf16":
            v = bf16_bits_to_f32(v)
        if cfg.steal_mantissa:
            vbits = v.view(np.uint32)
            src = np.broadcast_to((vbits & 0x7F).astype(np.int64),
                                  packed.shape).copy()
            v = (vbits & np.uint32(0xFFFFFF80)).view(np.float32)
            # dest-layout src: index directly by dest slot below
            src_by_dest = True
        else:
            src = (packed >> 11) & 0x7F
            src_by_dest = False
        pad = np.inf if cfg.semiring == "min_plus" else 0
        s_idx, lam_idx = np.nonzero(v != pad)
        jj = src[s_idx, lam_idx]
        bf = b[s_idx, jj]
        hh = h[s_idx, jj]
        if cfg.block_major:
            bf = wp.class_map[t][(s_idx // 128).astype(np.int64),
                                 bf]
        if cfg.two_choice:
            is2 = bf >= cfg.bank_blocks
            b0 = np.where(is2, bf - cfg.bank_blocks, bf)
            shifts = np.array([bank_shift(q) for q in range(cfg.bank_blocks)])
            j1 = np.where(is2, (jj - shifts[b0]) % LANES, jj)
        else:
            b0, j1 = bf, jj
        if cfg.block_major and cfg.two_choice:
            # secondary classes store a = h*B + b0 (stride copy)
            a = np.where(bf >= cfg.bank_blocks,
                         hh * cfg.bank_blocks + b0, b0 * 128 + hh)
        else:
            a = b0 * 128 + hh
        col = p * VB + a * LANES + j1
        if wp.col_order is not None:
            col = np.where(col < wp.num_cols, wp.col_order[np.minimum(col, wp.num_cols - 1)], col)
        sigma = s_idx % R
        rho = bk * RPB + sigma * LANES + lam_idx
        lins.append((t * S + s_idx) * LANES + lam_idx)
        rows.append(wp.perm[rho])
        cols.append(col)
        vals.append(v[s_idx, lam_idx])
    if rows:
        lins = np.concatenate(lins)
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        vals = np.concatenate(vals)
    else:
        lins = np.zeros(0, np.int64)
        rows = np.zeros(0, np.int64); cols = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float32 if cfg.dtype != "fixed" else np.uint32)
    return lins, rows, cols, vals


def save_wavepack(path, wp: Wavepack) -> None:
    """Persist packed streams (the preprocessing artifact; lets hosts skip
    csr2cpsr-equivalent work across runs — the reference re-preprocesses
    every run and pays seconds per dataset, paper Table 8).

    Every SpmvConfig field plus the class map round-trips: the decode()
    oracle on a loaded pack is byte-identical to the original."""
    cfg = wp.config
    np.savez_compressed(
        path,
        cfg=np.array([cfg.sublanes, cfg.bank_blocks, cfg.stripes,
                      int(cfg.steal_mantissa), int(cfg.two_choice),
                      int(cfg.block_major), cfg.classes_per_group,
                      int(cfg.idx16)],
                     np.int64),
        cfg_dtype=np.array(cfg.dtype),
        cfg_semiring=np.array(cfg.semiring),
        dims=np.array([wp.num_rows, wp.num_cols, wp.n_blocks, wp.n_parts,
                       wp.nnz, wp.opt_waves], np.int64),
        perm=wp.perm,
        vals=(wp.vals.view(np.uint16) if cfg.dtype == "bf16" else wp.vals),
        idxT=wp.idxT,
        tile_part=wp.tile_part, tile_block=wp.tile_block,
        tile_first=wp.tile_first, tile_last=wp.tile_last,
        col_order=(wp.col_order if wp.col_order is not None
                   else np.zeros(0, np.int64)),
        class_map=(wp.class_map if wp.class_map is not None
                   else np.zeros(0, np.int32)))


def load_wavepack(path) -> Wavepack:
    with np.load(path, allow_pickle=False) as f:
        c = [int(v) for v in f["cfg"]]
        if len(c) < 7:
            raise ValueError(
                "wavepack file predates full-config persistence; re-pack")
        S, B, R, steal, twoc, bm, K = c[:7]
        i16 = bool(c[7]) if len(c) > 7 else False
        cfg = SpmvConfig(sublanes=S, bank_blocks=B, stripes=R,
                         dtype=str(f["cfg_dtype"]),
                         steal_mantissa=bool(steal), two_choice=bool(twoc),
                         semiring=str(f["cfg_semiring"]),
                         block_major=bool(bm), classes_per_group=K,
                         idx16=i16)
        dims = [int(v) for v in f["dims"]]
        nr, nc, nb, npart, nnz = dims[:5]
        opt_waves = dims[5] if len(dims) > 5 else 0
        co = f["col_order"]
        cm = f["class_map"]
        return Wavepack(cfg, nr, nc, nb, npart, f["perm"], f["vals"],
                        f["idxT"], f["tile_part"], f["tile_block"],
                        f["tile_first"], f["tile_last"], nnz,
                        col_order=co if co.size else None,
                        class_map=cm if cm.size else None,
                        opt_waves=opt_waves)


def _schedule_block_major(sigma, lam, bank, h, cls, cls2, bank2, R, S, CT,
                          K, stop_frac=0.0, bm_win=BM_WIN, bm_adv=BM_ADV):
    """Class-group scheduler: every 128-wave group of a tile serves K
    x-blocks ("classes"), chosen per group by pending demand, so the kernel
    needs only K gathers + K-1 selects per group regardless of the block
    count.  Requires R % 128 == 0 (a group's waves cover one contiguous
    128-stripe range).  Items (distinct columns) may serve via their
    primary class (cls, bank) or the cross-class second choice
    (cls2, bank2).

    Returns (t_of, s_of, lane_of, bsel_of, choice_of, class_map):
    bsel_of is the local class index within the group's class list;
    class_map has shape (T, S//128, K).
    """
    n = sigma.shape[0]
    G = S // 128
    Rp = R // 128                      # stripe-groups per block
    t_of = np.full(n, -1, np.int64)
    s_of = np.zeros(n, np.int64)
    lane_of = np.zeros(n, np.int32)
    bsel_of = np.zeros(n, np.int32)
    choice_of = np.zeros(n, np.uint8)

    key = (((sigma.astype(np.int64) * (int(cls.max()) + 1 if n else 1)
             + cls) * 128 + bank) * 128 + h)
    order = np.argsort(key, kind="stable")
    pend = {}        # (sigma, class) -> multi-item ents, desc by count
    # (sigma, class) -> singleton entries [nz, lam, bank, primary, c_other]
    # (C++ twin packs these into one uint64 each); the large singleton
    # majority on hub-heavy graphs is scanned without item machinery
    pend1 = {}
    # per (stripe, row lane, class): pending nonzeros reachable via that
    # class (primary or secondary); rows_cnt counts rows with any
    cnt_rlc = np.zeros((R, LANES, CT), np.int32)
    i = 0
    total = 0
    while i < n:
        nz0 = order[i]
        sg, c1, b1, hh = (int(sigma[nz0]), int(cls[nz0]), int(bank[nz0]),
                          int(h[nz0]))
        j = i
        q = []
        while (j < n and sigma[order[j]] == sg and cls[order[j]] == c1
               and bank[order[j]] == b1 and h[order[j]] == hh):
            q.append(order[j])
            j += 1
        c2 = int(cls2[nz0])
        for nz in q:
            cnt_rlc[sg, lam[nz], c1] += 1
            if c2 != c1:
                cnt_rlc[sg, lam[nz], c2] += 1
        total += len(q)
        if len(q) == 1:
            nz = q[0]
            lm = int(lam[nz])
            pend1.setdefault((sg, c1), []).append([nz, lm, b1, 1, c2])
            if c2 != c1:
                pend1.setdefault((sg, c2), []).append(
                    [nz, lm, int(bank2[nz0]), 0, c1])
            i = j
            continue
        q.reverse()
        # ent: [count, b1, b2, c1, c2, rows, stamp_serial, stamp_mask]
        ent = [len(q), b1, int(bank2[nz0]), c1, c2, q, -1, 0]
        pend.setdefault((sg, c1), []).append(ent)
        if c2 != c1:
            pend.setdefault((sg, c2), []).append(ent)
        i = j
    rows_cnt = (cnt_rlc > 0).sum(axis=1).astype(np.int64)   # (R, CT)

    for lst in pend.values():
        lst.sort(key=lambda e: -e[0])

    # Rolling-window wave batching (C++ twin:
    # _scheduler.cpp::schedule_bm_segment).  Window slots 0..admitted-1
    # hold tiles t_win..t_win+admitted-1; per (group, u) the walk places
    # items into any in-window wave via per-lane / per-bank wave bitmasks
    # that PERSIST across passes (shifted right on advance), so every tile
    # accumulates placements over BM_WIN/BM_ADV dedicated passes while
    # list traversals drop by ~BM_ADV vs a per-tile walk.  Each tile's K
    # classes per group are fixed by pending row coverage at admission.
    W = max(1, min(int(bm_win), 64))
    ADV = max(1, min(int(bm_adv), W))
    lmask = [[0] * LANES for _ in range(G * 128)]   # per (g,u) walk
    bmask = [[0] * LANES for _ in range(G * 128)]
    # forward-only exam cursors per (walk, class): within one window
    # epoch (no new tile-mask bit for the class) masks only grow, so an
    # entry found blocked stays blocked — each exam RESUMES where the
    # last stopped, and the cursor resets when a fresh admitted tile
    # selects the class (C++ twin: _scheduler.cpp cur_lst/cur_sgl)
    prev_tm = {}
    cur_l = {}
    cur_s = {}
    sel = np.zeros((G, W, K), np.int32)             # class per (g,slot,k)
    tilemask = [[0] * CT for _ in range(G)]         # slot bits per (g,c)
    bsel_tab = np.full((G, CT, W), -1, np.int8)     # k of c in slot's sel
    placed_w = [0] * W
    class_map = []
    t_win = 0
    high = -1
    admitted = 0
    walk_serial = 0
    zero_streak = 0
    min_tile = int(stop_frac * S * LANES)
    while total > 0:
        admit = min(ADV, W - admitted)
        for anew in range(admit):
            slot = admitted + anew
            for g in range(G):
                gmod = g % Rp
                scores = rows_cnt[gmod * 128:gmod * 128 + 128].sum(axis=0)
                top = np.argsort(-scores, kind="stable")[:K]
                for kk in range(K):
                    c = int(top[kk])
                    sel[g, slot, kk] = c
                    tilemask[g][c] |= 1 << slot
                    bsel_tab[g, c, slot] = kk
        admitted += admit
        pass_placed = 0
        for g in range(G):
            gmod = g % Rp
            # class walk order: slot-major over the window's selections
            corder = []
            cseen = bytearray(CT)
            for w in range(admitted):
                for kk in range(K):
                    c = int(sel[g, w, kk])
                    if not cseen[c]:
                        cseen[c] = 1
                        corder.append(c)
            for u in range(128):
                sg = gmod * 128 + u
                s_glob = g * 128 + u
                walk_serial += 1
                lane_mask = lmask[g * 128 + u]
                bank_mask = bmask[g * 128 + u]
                for c in corder:
                    lst = pend.get((sg, c), ())
                    sgl = pend1.get((sg, c), ())
                    if not lst and not sgl:
                        continue
                    tm = tilemask[g][c]
                    if not tm:
                        continue
                    wc = (g * 128 + u, c)
                    if tm & ~prev_tm.get(wc, 0):   # fresh capacity: rescan
                        cur_l[wc] = 0
                        cur_s[wc] = 0
                    prev_tm[wc] = tm
                    ii = cur_l.get(wc, 0)
                    jj0 = cur_s.get(wc, 0)
                    if ii >= len(lst) and jj0 >= len(sgl):
                        continue                   # epoch exhausted
                    fruitless = 0
                    while ii < len(lst):
                        if fruitless >= 256:
                            break
                        ent = lst[ii]
                        if ent[0] == 0:          # drained: swap-remove
                            lst[ii] = lst[-1]
                            lst.pop()
                            continue             # revisit slot ii
                        if ent[6] != walk_serial:  # lazy stamp reset
                            ent[6] = walk_serial
                            ent[7] = 0
                        c1, c2 = ent[3], ent[4]
                        is_primary = (c1 == c)
                        lane = ent[1] if is_primary else ent[2]
                        # waves this item may still use: class selected in
                        # the tile, bank free, not already placed into by
                        # this item this walk (one column per (wave, bank)
                        # — the emission invariant)
                        avail = tm & ~bank_mask[lane] & ~ent[7]
                        if not avail:
                            ii += 1
                            fruitless += 1
                            continue
                        q = ent[5]
                        placed = 0
                        placed_mask = 0
                        kept_nz = []
                        while q:
                            nz = q.pop()
                            lm = int(lam[nz])
                            cand = avail & ~lane_mask[lm]
                            if not cand:
                                kept_nz.append(nz)
                                continue
                            w = (cand & -cand).bit_length() - 1
                            lane_mask[lm] |= 1 << w
                            t_of[nz] = t_win + w
                            s_of[nz] = s_glob
                            lane_of[nz] = lane
                            bsel_of[nz] = int(bsel_tab[g, c, w])
                            choice_of[nz] = 0 if is_primary else 1
                            cnt_rlc[sg, lm, c1] -= 1
                            if cnt_rlc[sg, lm, c1] == 0:
                                rows_cnt[sg, c1] -= 1
                            if c2 != c1:
                                cnt_rlc[sg, lm, c2] -= 1
                                if cnt_rlc[sg, lm, c2] == 0:
                                    rows_cnt[sg, c2] -= 1
                            placed_mask |= 1 << w
                            placed_w[w] += 1
                            if t_win + w > high:
                                high = t_win + w
                            placed += 1
                        kept_nz.reverse()
                        q.extend(kept_nz)
                        if placed:
                            bank_mask[lane] |= placed_mask
                            ent[7] |= placed_mask
                            ent[0] = len(q)
                            pass_placed += placed
                            total -= placed
                            fruitless = 0
                        else:
                            fruitless += 1
                        ii += 1
                    cur_l[wc] = ii
                    # singleton sub-walk (C++ twin: sequential packed
                    # scan); a single placed via its other class list is
                    # detected by t_of and swap-removed
                    jj = jj0
                    while jj < len(sgl):
                        if fruitless >= 256:
                            break
                        nz, lm, lane, primary, c_oth = sgl[jj]
                        # mask tests FIRST, placed-elsewhere second: the
                        # C++ twin defers its random placed-bitset probe
                        # until the entry has candidate waves (the
                        # blocked majority never pays the cache miss);
                        # dead entries linger while bank-blocked and are
                        # removed at first unblocked visit.  Same test
                        # order here — change BOTH.
                        cand = tm & ~bank_mask[lane] & ~lane_mask[lm]
                        if not cand:
                            jj += 1
                            fruitless += 1
                            continue
                        if t_of[nz] >= 0:        # placed elsewhere: remove
                            sgl[jj] = sgl[-1]
                            sgl.pop()
                            continue             # revisit slot jj
                        w = (cand & -cand).bit_length() - 1
                        c1 = c if primary else c_oth
                        c2 = c_oth if primary else c
                        lane_mask[lm] |= 1 << w
                        bank_mask[lane] |= 1 << w
                        t_of[nz] = t_win + w
                        s_of[nz] = s_glob
                        lane_of[nz] = lane
                        bsel_of[nz] = int(bsel_tab[g, c, w])
                        choice_of[nz] = 0 if primary else 1
                        cnt_rlc[sg, lm, c1] -= 1
                        if cnt_rlc[sg, lm, c1] == 0:
                            rows_cnt[sg, c1] -= 1
                        if c2 != c1:
                            cnt_rlc[sg, lm, c2] -= 1
                            if cnt_rlc[sg, lm, c2] == 0:
                                rows_cnt[sg, c2] -= 1
                        placed_w[w] += 1
                        if t_win + w > high:
                            high = t_win + w
                        pass_placed += 1
                        total -= 1
                        fruitless = 0
                        sgl[jj] = sgl[-1]        # placed: swap-remove
                        sgl.pop()
                    cur_s[wc] = jj
        if total == 0:
            break
        if pass_placed == 0:
            # defensive: once the whole window has been re-selected with
            # no placement, nothing pending can ever place
            zero_streak += 1
            if zero_streak > W // ADV + 1:
                break
        else:
            zero_streak = 0
        if admitted == W:
            # retire the ADV oldest tiles: emit class_map rows, shift the
            # window state down
            retired_placed = sum(placed_w[:ADV])
            for wr in range(ADV):
                class_map.append(sel[:, wr, :].copy())
            for masks in (lmask, bmask):
                for row in masks:
                    for e in range(LANES):
                        row[e] >>= ADV
            for kk2 in prev_tm:
                prev_tm[kk2] >>= ADV
            for g in range(G):
                for c in range(CT):
                    tilemask[g][c] >>= ADV
            sel[:, :W - ADV, :] = sel[:, ADV:, :]
            bsel_tab[:, :, :W - ADV] = bsel_tab[:, :, ADV:]
            bsel_tab[:, :, W - ADV:] = -1
            placed_w = placed_w[ADV:] + [0] * ADV
            admitted -= ADV
            t_win += ADV
            if min_tile and retired_placed < min_tile * ADV:
                break
    # flush class_map rows for in-window tiles that received placements,
    # then trim to exactly T_seg rows
    T_seg = high + 1
    for tt in range(t_win, T_seg):
        class_map.append(sel[:, tt - t_win, :].copy())
    class_map = class_map[:T_seg]
    t = T_seg
    if not class_map:
        class_map.append(np.zeros((G, K), np.int32))
        t = 1
    return t_of, s_of, lane_of, bsel_of, choice_of, np.stack(class_map)



def pack_hybrid(m: CSRMatrix, cfg_bulk: SpmvConfig,
                cfg_tail: SpmvConfig | None = None,
                split_max: int | None | str = "auto",
                stop_frac: float = 0.25,
                col_order: np.ndarray | str | None = None):
    """Two-phase packing: the block-major scheduler packs the bulk and
    stops when tiles go thin (the coupon-collector tail of sparse stripes);
    the leftovers repack through the select-chain path, which serves every
    block per wave.  Both packs share the split, renaming and y geometry,
    so y = y_bulk + y_tail elementwise in renamed space.

    fp32 plus_times only (the elementwise merge is a plain add).  With
    ``col_order="degree"`` each pack orders its own columns (the bulk by
    the split matrix's degrees, the tail by the leftovers'), so each
    operator permutes x by its own ``col_order``.
    Returns (wp_bulk, wp_tail).
    """
    if not cfg_bulk.block_major:
        raise ValueError("pack_hybrid needs a block-major bulk config")
    if cfg_bulk.dtype != "fp32" or cfg_bulk.semiring != "plus_times":
        raise ValueError("pack_hybrid supports fp32 plus_times only")
    if cfg_tail is None:
        cfg_tail = dataclasses.replace(
            cfg_bulk, block_major=False,
            bank_blocks=min(cfg_bulk.bank_blocks, 8),
            two_choice=cfg_bulk.bank_blocks <= 8 and cfg_bulk.two_choice)
    if (cfg_tail.sublanes != cfg_bulk.sublanes
            or cfg_tail.stripes != cfg_bulk.stripes):
        raise ValueError("bulk and tail must share sublanes/stripes "
                         "(same y geometry)")
    orig_rows = m.num_rows
    if split_max == "auto":
        mean = max(float(m.nnz) / max(m.num_rows, 1), 1.0)
        split_max = max(8, 1 << int(np.ceil(np.log2(mean))))
    if split_max is not None:
        from .csr import split_rows
        m2, row_map = split_rows(m, split_max)
    else:
        m2, row_map = m, np.arange(m.num_rows, dtype=np.int64)
    row_order = argsort_rows_by_nnz(m2, descending=True)

    lo_out: dict = {}
    wp_bulk = pack(m2, cfg_bulk, row_order=row_order, col_order=col_order,
                   _stop_frac=stop_frac, _leftover_out=lo_out)
    left = lo_out.get("nz", np.zeros(0, np.int64))
    rows_of_nz = np.repeat(np.arange(m2.num_rows), m2.row_nnz())
    import scipy.sparse as sp
    coo = sp.coo_matrix((m2.data[left],
                         (rows_of_nz[left], m2.indices[left])),
                        shape=(m2.num_rows, m2.num_cols))
    m_tail = CSRMatrix.from_scipy(coo.tocsr())
    wp_tail = pack(m_tail, cfg_tail, row_order=row_order,
                   col_order=col_order)
    # fix up both perms to map to ORIGINAL rows (pack applied row_map only
    # when it did the splitting itself)
    for wp in (wp_bulk, wp_tail):
        p = wp.perm
        wp.perm = np.where(p < m2.num_rows,
                           row_map[np.minimum(p, m2.num_rows - 1)],
                           orig_rows)
        wp.num_rows = orig_rows
    if not np.array_equal(wp_bulk.perm, wp_tail.perm):
        raise ValueError("the bulk and tail packs renamed rows apart")
    return wp_bulk, wp_tail
