"""Overlay-wide configuration — the TPU-native analog of the reference's L1 layer.

A copy of ``hisparse_tpu/config.py``.  In the port ``LANES = 128`` is a
constant of the wavepack format (the width of every stream tile), not a
lane count of the GPU; the table below records where the format came from.

The reference (cornell-zhang/HiSparse) fixes its design point in
``spmv/libfpga/common.h``: ``PACK_SIZE=8`` lanes per HBM channel (:30),
``VAL_T = ap_ufixed<32,8,AP_RND,AP_SAT>`` (:35-39), 16 HBM channels
(:171-175), output-buffer bank of 8192 words and vector-buffer bank of 4096
words (:163-166), giving a 1M-row x 32K-col logical tile (:177-179).  The
benchmark host then overrides the logical tile sizes at runtime
(``sw/benchmark.cpp:112-115``).

Here the same role is played by :class:`SpmvConfig`: one dataclass holding
the geometry of the packed stream format and the kernel, overridable per run
and swept by the DSE (models/dse.py).

TPU mapping of the reference's constants:

===========================  ==================================================
reference                    this framework
===========================  ==================================================
PACK_SIZE=8 (lanes/channel)  LANES=128 (VPU lane count; one slot per lane)
NUM_HBM_CHANNELS=16          the single HBM stream; multi-chip via parallel/
OB_BANK_SIZE (8192 words)    ROWS_PER_BLOCK = stripes*LANES (acc tile in VMEM)
VB_BANK_SIZE (4096 words)    VB = bank_blocks*128*LANES cols resident in VMEM
SPMV_MAT_PKT_T (512 bit)     one (sublanes x 128) tile of vals + packed idx
IDX_MARKER / SOD/EOD/EOS     explicit per-tile block/partition id arrays
                             (scalar-prefetched); TPU control flow must be
                             data-independent, so in-band markers become
                             out-of-band schedules
===========================  ==================================================
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LANES = 128  # TPU VPU lane count; the analog of the reference's PACK_SIZE=8.


@dataclasses.dataclass(frozen=True)
class SpmvConfig:
    """Design point for the wavepack format + SpMV kernel.

    Attributes:
      sublanes: tile height S. One streamed matrix tile is (S, 128) slots.
        Must be a multiple of 128 (the kernel processes 128-row sublane
        groups when gathering).
      bank_blocks: B, number of 128-deep source blocks in the vector buffer.
        The resident x tile holds ``VB = B*128*128`` columns, the analog of
        the reference's LOGICAL_VB_SIZE (common.h:178: 4096*8=32K; ours with
        B=2 is 32K as well, B=4 is 64K).
      stripes: R, number of row stripes per row block.  A row block covers
        ``R*128`` rows; each row owns ``S//R`` wave slots per tile.  Small R
        suits dense rows (pruned-NN), large R suits sparse rows (graphs).
        The analog of the OB bank-size knob (common.h:163).
      dtype: value type of the stream. 'fp32' | 'fixed' (saturating unsigned
        Q8.24 emulated on int32, matching ap_ufixed<32,8,AP_RND,AP_SAT>,
        common.h:35-39) | 'bf16' (matrix values emitted as bfloat16 —
        6 bytes/slot instead of 8; x and the accumulator stay fp32, so the
        error is one bf16 rounding per term (~2^-8 relative), the analog of
        the reference's reduced-precision float overlays,
        spmv-fp/libfpga/common.h:26.  Requires steal_mantissa=False).
      steal_mantissa: fp32 fast path — store the crossbar source lane in the
        7 low mantissa bits of each value (relative error <= 2^-17, far
        below the reference's 1e-4 test tolerance, sw/host.cpp:62).  When
        False the source lane travels in the index word and is transposed
        back in-kernel (exact; required for 'fixed').
      semiring: accumulation algebra.  'plus_times' is SpMV; 'min_plus'
        (tropical) drives SSSP/Bellman-Ford; 'max_times' over 0/1 weights is
        boolean or-and for BFS frontiers.  The GraphLily lineage the
        reference documents in its vestigial app tests
        (unit_tests/test_app.cpp, test_module_spmv_spmspv.cpp).
      block_major: every 128-wave group of a tile serves a small set of
        x-blocks ("classes") chosen per group by the packer and shipped as
        a class map, so the kernel does classes_per_group gathers per group
        regardless of bank_blocks — block count stops costing compute.
        Needs stripes % 128 == 0.
      classes_per_group: k, how many classes one group serves (k gathers +
        k-1 selects per group).  k=1 is pure block-major (starves thin
        stripes); k=4 balances compute vs schedule density.
      idx16: emit the index stream as int16 instead of int32 (6 bytes/slot
        with fp32 values instead of 8) — steal_mantissa packs store only
        b(4)|h(7) = 11 bits per idx word, so the high half is pure padding.
        Halves index-stream HBM traffic; the kernel widens the tile to i32
        once in VMEM (one cheap unpack op).  Requires steal_mantissa.
      two_choice: power-of-two-choices banking — the x tile is additionally
        materialized with each 128-deep block rotated along banks by a
        per-block shift, giving every column a second candidate bank; the
        wave scheduler picks whichever is free, collapsing the max-bank-load
        (birthday) term that otherwise dominates padding.  Doubles the
        resident x tile and the gather select chain.  This is the TPU analog
        of widening the shuffler's arbitration window (shuffle.h:211-377).
    """

    sublanes: int = 512
    bank_blocks: int = 2
    stripes: int = 512
    dtype: Literal["fp32", "fixed", "bf16"] = "fp32"
    steal_mantissa: bool = False
    two_choice: bool = True
    semiring: Literal["plus_times", "min_plus", "max_times"] = "plus_times"
    block_major: bool = False
    classes_per_group: int = 4
    idx16: bool = False

    def __post_init__(self):
        if self.sublanes % LANES != 0:
            raise ValueError(f"sublanes must be a multiple of {LANES}")
        if self.sublanes % self.stripes != 0:
            raise ValueError("stripes must divide sublanes")
        # the select-chain path stores the block id in the idx word's 4-bit
        # b-field, capping B at 16 (8 with the two-choice bit); block-major
        # stores only the local class index (< classes_per_group), so B can
        # grow until the resident x tile hits VMEM — large B shrinks the
        # column-partition count, which collapses the per-segment tile tail
        # on spread-column graphs (the pokec regime)
        cap = 128 if self.block_major else 16
        if self.bank_blocks < 1 or self.bank_blocks > cap:
            raise ValueError(f"bank_blocks must be in [1, {cap}]"
                             + ("" if self.block_major
                                else " (4-bit block field)"))
        if (self.two_choice and self.bank_blocks > 8
                and not self.block_major):
            raise ValueError("two_choice needs bank_blocks <= 8 "
                             "(4-bit block field) unless block_major")
        if self.dtype == "fixed" and self.steal_mantissa:
            raise ValueError("fixed-point stream cannot steal mantissa bits")
        if self.dtype == "bf16" and self.steal_mantissa:
            raise ValueError("bf16 stream has no mantissa bits to steal "
                             "(7-bit mantissa; the crossbar lane needs 7)")
        if self.semiring != "plus_times" and self.dtype != "fp32":
            raise ValueError("non-plus_times semirings need fp32")
        if self.steal_mantissa and self.semiring == "min_plus":
            raise ValueError("steal_mantissa breaks inf padding (min_plus)")
        if self.block_major and self.stripes % 128 != 0:
            raise ValueError("block_major needs stripes % 128 == 0")
        if self.block_major and self.classes_per_group not in (1, 2, 4, 8):
            raise ValueError("classes_per_group must be 1, 2, 4 or 8")
        if self.idx16 and not self.steal_mantissa:
            raise ValueError(
                "idx16 needs steal_mantissa: without it the idx word "
                "carries src(7)|b(4)|h(7) = 18 bits; with it only "
                "b(4)|h(7) = 11, which fits int16")

    @property
    def total_blocks(self) -> int:
        """Gather-operand block count (doubled by two-choice banking)."""
        return self.bank_blocks * (2 if self.two_choice else 1)

    @property
    def vb_cols(self) -> int:
        """Columns resident per partition (LOGICAL_VB_SIZE analog)."""
        return self.bank_blocks * 128 * LANES

    @property
    def rows_per_block(self) -> int:
        """Rows per row block (LOGICAL_OB_SIZE analog, common.h:177)."""
        return self.stripes * LANES

    @property
    def slots_per_row_per_tile(self) -> int:
        return self.sublanes // self.stripes

    @property
    def tile_slots(self) -> int:
        return self.sublanes * LANES

    @property
    def groups(self) -> int:
        """128-sublane groups per tile."""
        return self.sublanes // 128


# Default design points, the analog of the DSE-chosen ob=8K/vb=4K of the
# paper (SURVEY.md section 6).  Graphs want many rows in flight; pruned-NN
# wants many slots per row.
GRAPH_CONFIG = SpmvConfig(sublanes=512, bank_blocks=8, stripes=512,
                          block_major=True, classes_per_group=4,
                          steal_mantissa=True)
NN_CONFIG = SpmvConfig(sublanes=512, bank_blocks=2, stripes=4)
