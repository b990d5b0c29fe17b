"""Smoke run of hisparse_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  1. require a CUDA device; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them;
  2. build the six CUDA kernels (nvcc, sm_90a, one process for each of
     the four sources, in parallel; SpMV, SpMM and the masked SpMV share
     one kernel body) and the native packer (g++) from the sources in this
     checkout; print the build seconds, each kernel's registers per
     thread (``ptxas -v``, the sources compiled once more), for every
     instantiation of the SpMV / SpMM / masked body its registers, static
     and dynamic shared memory, spilled bytes and resident CTAs per SM
     (``_kernels.kernel_info``), and whether the committed rates file
     (models/rates_h100.json) names this card;
  3. on the plus_times parity families of the JAX package's chip sweep
     (fp32, Q8.24 and bf16 values, plus one two-block pack), hold the SpMV
     kernel against its plain PyTorch version on the same CUDA operands
     (max|dy|/max|y| <= 1e-6 for fp32; bf16 and Q8.24 bit for bit) and
     natural y through each against the golden (f64 within 1e-4, bf16
     within 1e-4 of the golden of its rounded values and 8e-3 of the
     unrounded; Q8.24 equal to golden.spmv_fixed_vec), through the parity
     sweep's own check (utils/parity.spmv_family);
  4. serving at full size: the googleplus stand-in of the suite,
     powerlaw_csr(108000, 108000, 127, 1.2, seed=11), packed natively at
     its tuned design point, through SpmvOperator(wp, device="cuda") to
     natural-order y; y within 1e-4 of spmv_f64, and the SpMV kernel's
     launch counter, zeroed just before, above 0.  Then the kernel (with
     and without its host enqueue), its plain version, the whole forward
     and a cuSPARSE CSR SpMV (torch.sparse_csr_tensor @ x, a yardstick
     only) are timed on CUDA events and printed with GOPS = 2*nnz/t and
     GB/s = bytes/t; the renamed -> natural fold kernel bit for bit
     against its plain version and Wavepack.unpack_y, timed beside its
     bound, its plain version and index_add_ over perm (the earlier
     unpack, a yardstick only), and its longest hub row timed alone
     beside the chain floor (the row's partials times one dependent fp32
     add's clocks, csrc/row_fold.cu's timer run once, over the card's
     clocks.max.sm);
  5. on the same families, the gradient-stream kernel against its plain
     version (max|d| <= 1e-6 of max|out|) and the SpMM kernel against its
     plain version at F = 1, 5 and 16 (max|d|/max|Y| <= 1e-6) and, through
     the wide instantiation, at F = 20, 36, 48 and 64 bit for bit (the
     bf16 stream at F = 1, 3, 5, 8 and 16 bit for bit); on the
     min_plus and max_times families the SpMV kernel bit for bit against
     its plain version and within 1e-4 of the float64 oracle, SpMM at F = 5
     bit for bit; on every fp32 family in each semiring its config allows,
     the masked kernel bit for bit against its plain version with 40
     active columns, and masked == full (natural order); a NaN in x in
     the same slots through the SpMV, masked and SpMM kernels and their
     plain versions; the fold on hub-split packs (the min_plus and
     max_times families and the Q8.24 family here, googleplus in phase 4,
     the fixed row in phase 9): two forwards, two masked calls and two
     matmul calls (float packs) bit-equal to each other in natural order
     and to Wavepack.unpack_y of the same call's renamed y; the fold
     kernel on the hand-made edge plan (utils/bench.fold_edge_plan: ties
     of signed zeros, two NaN payloads, infinities, a saturating Q8.24
     hub row, rows of 32 and 33 partials) in every algebra at F = 1, 3,
     16 and 20, both layouts, bit for bit against its plain version and
     Wavepack.unpack_y;
  6. training at full size: the transformer-70 stand-in of the suite's
     training row (bench.py, diffspmv_tracking_row), uniform_sparse_csr(
     512, 33288, 9986, seed=70), at that row's configs: StreamDiffSpmv
     takes 5 SGD steps on 0.5*|A x - y_t|^2.  Step 1's y and x_bar within
     1e-4 of float64 scipy on the stream's values, dA equal to
     g[rows]*x[cols] on the card bit for bit, the two layouts' values
     bit-equal after every step, the loss falling, the SpMV and
     gradient-stream counters above 0, and one DiffSpmv forward + backward
     within 1e-6 of the stream path.  Then one gradient step through the
     kernels against the same step through the plain versions on the same
     streams: y and x_bar (the SpMV kernel on the A and A^T packs) within
     1e-6, both gradient streams bit for bit.  The forward, a whole
     gradient step and the same step through the plain versions are
     timed, and the forward and the step profiled; the gradient stream is
     timed beside torch.sparse.sampled_addmm on A's CSR pattern (g x^T
     sampled there: the same dL/dvals in CSR order, a yardstick only);
  7. GCN at full size: two layers, hidden width 16 (Kipf & Welling), on
     the googleplus stand-in, 64 input features and 8 classes from numpy
     seeds, the adjacency packed at phase 4's design point: logits within
     1e-4 of a float64 scipy oracle, the cross-entropy falling over 3 SGD
     steps, the SpMM counter above 0; the SpMM kernel against its plain
     version on A-hat and A-hat^T at F = 8 and 16 (1e-6); one training
     step is timed and profiled, the SpMM kernel timed at F = 16, the
     fold of A-hat's F = 16 renamed rows in both layouts ((n, F), as the
     natural-order matmul folds them, and (F, n)) beside index_add_, and
     the natural-order matmul at F = 16 (SpMM, stripe fold, fold), its
     output a contiguous (n, 16).  The SpMM kernel on A-hat at F = 64
     (the wide instantiation) bit for bit against its plain version;
     matmul at F = 100 (launches of 64 and 36 features) bit for bit the
     same features taken 16 at a time, the wide launches counted
     (``_kernels.spmm_wide_launches``), and one wide launch timed beside
     the four kF = 16 launches of the same 64 features.  Then a GCN on a
     symmetric graph
     (APPS_100K's matrix made undirected), widths SYM_GCN_DIMS, dropout
     0.5: one pack serves both directions (agg.opT is agg.op), one
     training step's kernel launches by direction are the chunks of its
     widths (DiffSpmm.launches_fwd / launches_bwd; the wide ones those of
     chunks over 16 features), its backward products
     A^T G at F = 47 and 8 within 1e-6 of float64, and the step's loss
     and gradients within 1e-3 (normwise) of the plain reference's
     float64 step (hisparse_tpu_torch/reference/gcn.py) on the same
     dropout masks.

  8. the graph apps at the suite's sizes (bench.py:736-800): PageRank
     (20 iterations) and BFS (from vertex 0, dense and masked) on
     powerlaw_csr(100000, 100000, 10, alpha=1.3, seed=2), SSSP (from
     vertex 0 to the fixpoint, dense and masked) on the pokec stand-in
     rmat_csr(1632000, 1632000, 19, seed=6), every run counted: PageRank
     within 1e-4 of pagerank_reference (max|r - ref| / max|ref|), BFS levels
     equal to scipy's, SSSP within 1e-4 (relative, at least 1) of Dijkstra
     with the same vertices unreachable, masked equal to dense, the SpMV
     and masked counters above 0, one fold into rank order for each SpMV
     and masked launch.  Then the SpMV kernel against its plain version on
     the PageRank pack, the BFS pack and the pokec pack, and the masked
     kernel at a BFS frontier and a mid-run SSSP frontier, bit for bit (the
     plain versions walk the 680M-slot pokec stream in chunks); the fold
     into rank order against the plain fold on each app's renamed y
     (PageRank plus_times, BFS max_times at its frontier, SSSP min_plus),
     bit for bit; one SSSP step counted (one SpMV launch and one fold);
     the two kernels timed on the pokec pack beside
     their bounds; the PageRank, BFS and SSSP steps timed (PageRank beside
     a cuSPARSE CSR SpMV of its matrix) and profiled; generate, pack and
     Dijkstra seconds and the masked call's host time printed; the SpMV
     kernel and the SpMM kernel at F = 16 on the PageRank pack (4 column
     partitions) timed beside their bounds and cuSPARSE;
  9. the format dispatch at the suite's sizes: choose_format (on the
     committed card rates) on bcsr-spmm-16k (block_structured_csr(16384,
     16384, block_rows=24, seed=7), bench.py:897-921), the six
     transformer_* matrices of the pruned-NN suite (bench.py:533-537) and
     googleplus, each pick printed, bcsr-spmm-16k's required to be bcsr
     and, once both arms are timed, the faster of its BCSR and dense
     forwards; then, counted, bcsr-spmm-16k through
     BcsrOperator bf16 with 64 right-hand sides from default_rng(1) (as
     bench.py's row runs it, whatever the pick), each transformer matrix
     picked dense through DenseOperator bf16, and the fixed-point row
     (uniform_sparse_csr(60000, 60000, 16, seed=1) at its tuned point,
     bench.py:677-679, bench_tuned.json) through SpmvOperator: the fixed
     row bit for bit equal to golden.spmv_fixed_vec and its kernel to its
     plain version; bcsr-spmm-16k within 1e-4 (of max|Y|) of a float64
     product of the bf16-rounded blocks and X, the kernel within 1e-4 of
     its plain version, fp32 blocks at k = 1 and 64 within 1e-4 of f64;
     the dense picks within 1e-4 of a float64 product of the bf16-rounded
     operands; the BCSR and SpMV counters above 0.  The BCSR kernel is
     timed beside its bound, its plain version, cuSPARSE
     (torch.sparse.mm(csr_fp32, X)) and a PyTorch BSR product
     (torch.sparse_bsr_tensor @ X, bf16), yardsticks only, and beside the
     dense arm on the same product (SpmmOperator bf16); the fixed row's
     kernel beside its bound, in GOPS, and its forward (the device fold,
     one copy to the host), and its Q8.24 fold against its plain version
     and unpack_y; each dense pick's forward beside its bound and the
     wavepack forward of the same matrix.
 10. the mesh on one card (``hisparse_tpu_torch.parallel``), four shards
     on ``cuda:0``: ShardedSpmv on googleplus at its design point (split_max 64, no
     column order) within 1e-4 of spmv_f64 and bit-equal run to run,
     ShardedSpmv2D (2 x 2) and ShardedSpmvMultiHost (2 x 2) within 1e-4
     of it; the fixed row through ShardedSpmv bit for bit equal to
     golden.spmv_fixed_vec (each shard's words folded on the card);
     min_plus on the 100k graph through
     ShardedSpmv and ShardedSpmv2D bit-equal to the single-device
     operator; ShardedStreamDiffSpmv on transformer-70, 5 SGD steps, the
     loss falling, the layouts bit-equal after each step, step 1's y and
     x_bar within 1e-4 of float64; ShardedDiffSpmv (the same packs, its
     own values) y and x_bar within 1e-4 of float64 and dL/dvals
     bit-equal to g[rows] * x[cols]; ShardedGCN on googleplus with phase
     7's parameters, logits within 1e-5 of the single-device GCN, 3 SGD
     steps lowering the loss; ShardedPageRank within 1e-5 of
     pagerank_reference, ShardedBFS and ShardedSSSP equal to phase 8's
     levels and distances; the SpMV, SpMM, gradient-stream
     and fold counters, zeroed before, above 0; one shard of each of
     those kernels against its plain version; the min_plus hub-split
     folds (SSSP-pokec's first shard on its distances, the 100k graph at
     split 16) against their plain versions and unpack_y, timed beside
     scatter_reduce_; each shard's tiles; the
     sharded forwards and steps timed beside one
     operator's on the same matrices, and two of them profiled.
 11. tooling and the hybrid: phase 4's googleplus matrix through
     pack_hybrid (block-major bulk that stops when tiles go thin, the
     leftovers as a select-chain tail; split 64, degree column order, each
     pack its own) and HybridSpmv(device="cuda"): both packs' tiles, fill,
     MB and the host seconds printed; y within 1e-4 of spmv_f64; each of
     the two launches within 1e-6 of its plain version; natural y
     bit-equal run to run and to the CPU HybridSpmv on the same packs; the
     counted forward launches wavepack_spmv twice and row_fold once.  The
     kernel time of each launch, the hybrid forward, and the single pack's
     kernel and forward timed in turns (single, hybrid, hybrid, single)
     and printed beside phase 4's.  measure_spmv (the reference's
     benchmark row) of the single pack and the hybrid, with
     device_hbm_gbps and measured_peak_gbps; device_profile around three
     hybrid forwards into smoke_out/, its trace required to
     hold a wavepack kernel event; and parity_sweep over the 23 families of parity_tpu.json, every family
     required ok, its record written to
     smoke_out/parity_cuda.json.

Each phase prints its seconds.  The kernels' times keep the host's
enqueue out (``device_time_ms(queued=True)``); the forwards, steps and
plain versions are timed with it, as their callers wait for it.  A profile
(``utils/bench.profile_breakdown``) prints a call's device time by op and
its device idle share.  The line before the last is a JSON object with
the six kernels' records: launches by path, each time beside its bound
(the larger of the bytes it must move over 3.35 TB/s and its operations
over the peak named in ``peak``: 67 TFLOP/s fp32 outside the tensor
cores, or 989 TFLOP/s bf16 on them for the bf16 BCSR kernel) and, where
one PyTorch call computes the same function, that call's time
(``library_ms``: cuSPARSE SpMV, SpMM, SDDMM (``sampled_addmm``) for the
gradient stream, for BCSR, CSR SpMM, and for the fold ``index_add_`` over
perm, which sums in no fixed order; no PyTorch call computes a masked
SpMV), and for the wavepack kernels the instantiation the measured shape
launches (registers, shared memory, CTAs per SM); the fold's record also
holds its chain floor (``chain_floor_ms``), both layouts at F = 16, the
Q8.24 fixed row and the min_plus hub-split folds; the last is
``{"ok": true, "device": {...}}``.
"""
import functools
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

# the full-size design points, shared with the A/B tools
from hisparse_tpu_torch.ops.spmv import SPMM_MAX_F
from hisparse_tpu_torch.utils.bench import (APPS_100K, BCSR16K, BCSR_RHS,
                                            GCN_DIMS, GOOGLEPLUS,
                                            GOOGLEPLUS_CFG, GOOGLEPLUS_PACK,
                                            POKEC, T70, T70_CFG)

T70_CFG_T = dict(T70_CFG, stripes=512)
T70_STEPS, T70_LR = 5, 5e-5
GCN_STEPS, GCN_LR = 3, 0.5
# the symmetric GCN of phase 7: forward products at F = 20, 47, 8,
# backward at 47, 8, a launch a chunk of at most SPMM_MAX_F features
SYM_GCN_DIMS = [20, 47, 47, 8]
SYM_GCN_FWD, SYM_GCN_BWD = (20, 47, 8), (47, 8)


def chunks(widths, narrow: bool | None = None) -> int:
    """The SpMM launches of products at ``widths``: a chunk of at most
    SPMM_MAX_F features a launch; with ``narrow`` False only the chunks
    over 16 features, the wide instantiation's."""
    sizes = [min(SPMM_MAX_F, f - f0) for f in widths
             for f0 in range(0, f, SPMM_MAX_F)]
    return sum(1 for c in sizes if narrow is None or (c <= 16) == narrow)


SYM_GCN_LAUNCHES = (chunks(SYM_GCN_FWD), chunks(SYM_GCN_BWD))
# normwise against float64: a backward product sums a row's few dozen
# fp32 terms (as tests/test_torch_gcn_train.py holds matmul); a step's
# layer-1 gradients sum 10,000 training nodes' random-label terms that
# nearly cancel, so their rounding reads far above it (5.2e-5 for w0 on
# an H100, where w1 and w2 read 2e-7)
TOL_SYM_PRODUCT = 1e-6
# the feature counts at which phase 5 holds the wide SpMM instantiation
# bit for bit against its plain version
WIDE_FS = (20, 36, 48, 64)
TOL_SYM_STEP = 1e-3
PR_ITERS = 20                 # PageRank's iterations on APPS_100K
MASKED_ACTIVE = 40            # active columns of the phase-5 masked cases
# the dispatch rows (bench.py:533-537, :677-679, :897-921): the pruned-NN
# suite, the fixed-point row at its tuned point (bench_tuned.json) and the
# block-structured SpMM row (BCSR16K, BCSR_RHS)
TRANSFORMER_PCTS = (50, 60, 70, 80, 90, 95)
FIXED_ROW = dict(shape=(60000, 60000, 16), seed=1)
FIXED_CFG = dict(sublanes=512, bank_blocks=4, stripes=512, dtype="fixed",
                 block_major=True, classes_per_group=2, two_choice=True)
FIXED_PACK = dict(split_max=16, col_order="degree", bm_win=1, bm_adv=1)
TOL_PLAIN = 1e-6
TOL_F64 = 1e-4
# phase 10: four shards on one card; the sharded GCN and PageRank against
# the single-device GCN and the golden (the sums of a shard run in another
# order than the whole matrix's)
MESH_SHARDS = 4
TOL_MESH_GCN = 1e-5
TOL_MESH_PR = 1e-5
# phase 11: the hybrid pack of googleplus (pack_hybrid's own stop_frac)
# and the output directory of its trace and parity record
HYBRID_PACK = dict(split_max=64, col_order="degree")
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")
# the card's peaks for bound_ms (NVIDIA data sheet, H100 SXM at 700 W): HBM3
# bytes, fp32 operations outside the tensor cores and bf16 operations on
# them, a second
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16_tensor": 989e12}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def counts(kernels) -> dict:
    return {"wavepack_spmv": kernels.launches,
            "wavepack_gradstream": kernels.gradstream_launches,
            "wavepack_spmm": kernels.spmm_launches,
            "wavepack_spmv_masked": kernels.masked_launches,
            "bcsr": kernels.bcsr_launches,
            "row_fold": kernels.fold_launches}


def reset_counts(kernels) -> None:
    kernels.launches = 0
    kernels.gradstream_launches = 0
    kernels.spmm_launches = 0
    kernels.masked_launches = 0
    kernels.bcsr_launches = 0
    kernels.fold_launches = 0


def print_registers(counts: dict) -> None:
    """Registers per thread of each kernel, grouped by kind: the SpMV body
    by value word, features, algebra and masked flag (over the kinds of
    pack), the gradient stream and the BCSR kernels by name."""
    import re
    names = {"0": "plus_times", "1": "min_plus", "2": "max_times",
             "3": "fixed"}
    groups: dict = {}
    for sym, regs in counts.items():
        m = re.search(r"wavepack_kernelI([jt])[is]Lb\dELb\dELi(\d+)ELi(\d)"
                      r"ELb(\d)E", sym)
        other = next((k for k in ("wavepack_gradstream_kernel",
                                  "bcsr_bf16_kernel", "bcsr_f32_kernel",
                                  "row_fold_kernel", "fadd_latency_kernel")
                      if k in sym), sym)
        key = (f"wavepack_kernel {'bf16' if m[1] == 't' else '32-bit'} "
               f"kF={m[2]} {names[m[3]]}"
               + (" masked" if m[4] == "1" else "")) if m else other
        groups.setdefault(key, []).append(regs)
    for key in sorted(groups):
        r = groups[key]
        print(f"registers {key}: {min(r)}-{max(r)} ({len(r)} "
              "instantiations)", flush=True)


PACK_KINDS = (("chain", False, False, False), ("bm", False, False, True),
              ("steal", False, True, False), ("steal-bm", False, True, True),
              ("idx16", True, True, False), ("idx16-bm", True, True, True))


def print_kernel_info(kernels) -> None:
    """Every instantiation of the SpMV / SpMM / masked body: registers,
    static + dynamic shared memory, spilled bytes and resident CTAs per SM
    times threads per CTA, one line per entry, CTA shape, algebra and
    feature width over the kinds of pack it takes.  The SpMV and masked
    kernels take narrow CTAs for a pack of one row block of 512 sublanes
    and wide ones for a pack of many."""
    for which, Fp, n_blocks in (
            ("wavepack_spmv", 1, 1), ("wavepack_spmv", 1, 64),
            ("wavepack_spmv_masked", 1, 1), ("wavepack_spmv_masked", 1, 64),
            ("wavepack_spmm", 4, 1), ("wavepack_spmm", 8, 1),
            ("wavepack_spmm", 16, 1), ("wavepack_spmm", SPMM_MAX_F, 1)):
        for sr, dtype in (("plus_times", "fp32"), ("max_times", "fp32"),
                          ("min_plus", "fp32"), ("plus_times", "bf16"),
                          ("plus_times", "fixed")):
            if dtype == "fixed" and which != "wavepack_spmv":
                continue
            cells, stages, threads = [], 0, 0
            for kind, idx16, steal, bm in PACK_KINDS:
                if steal and (sr == "min_plus" or dtype != "fp32"):
                    continue
                i = kernels.kernel_info(which, semiring=sr, dtype=dtype,
                                        idx16=idx16, steal=steal,
                                        block_major=bm, Fp=Fp,
                                        n_blocks=n_blocks)
                stages, threads = i["stages"], i["threads"]
                cells.append(f"{kind} {i['registers']}r "
                             f"{i['static_smem']}+{i['dynamic_smem']}B "
                             f"spill {i['local_bytes']} "
                             f"{i['ctas_per_sm']}x{i['threads']} threads/SM")
            print(f"kernel {which} {dtype} {sr} Fp={Fp} {threads} threads "
                  f"(ring {stages}): " + "; ".join(cells), flush=True)


def instantiation(kernels, which, op, Fp: int = 1) -> dict:
    """kernel_info of the instantiation ``which`` launches for ``op``'s
    pack."""
    cfg = op.cfg
    return kernels.kernel_info(which, semiring=cfg.semiring,
                               dtype=cfg.dtype, idx16=cfg.idx16,
                               steal=cfg.steal_mantissa,
                               block_major=cfg.block_major, Fp=Fp,
                               n_blocks=op.wp.n_blocks, S=cfg.sublanes)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, n_ops: float, peak: str = "fp32") -> dict:
    """``bound_ms``, the least time the card could take for work that
    moves ``n_bytes`` and does ``n_ops`` operations at the ``peak`` rate
    (``PEAK_OPS_PER_S``), ``bound_by``, which of the two sets it, and the
    peak used."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[peak]
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "peak": peak}


def spmv_bound(args, out, F: int = 1, slots: int | None = None) -> dict:
    """The SpMV / SpMM kernels' bound: every operand read once, the
    accumulator written once, two operations a slot and feature."""
    vals = args[0]
    slots = vals.numel() if slots is None else slots
    return bound(nbytes(*args, out), 2.0 * slots * F)


def masked_bound(margs, out) -> dict:
    """The masked kernel's bound: only the selected tiles' values, idx
    words, partition ids and class maps are read."""
    vals, idxT, tile_ids, tile_part, cmap, rs, re, xt = margs[:8]
    n_sel, T = tile_ids.numel(), vals.shape[0]
    per_tile = (nbytes(vals, idxT, tile_part, cmap) / T) if T else 0
    slots = n_sel * vals.shape[1] * vals.shape[2]
    return bound(n_sel * per_tile + nbytes(tile_ids, rs, re, xt, out),
                 2.0 * slots)


def csr_tensor(m, dev):
    """A torch CSR tensor of a CSRMatrix (duplicates summed), for the
    cuSPARSE yardsticks.  ``to_scipy`` shares m's arrays and
    ``sum_duplicates`` sorts and compacts in place, so it runs on a copy:
    m stays as it was for the phases after."""
    import torch
    a = m.to_scipy().copy()
    a.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int32)),
        torch.from_numpy(a.indices.astype(np.int32)),
        torch.from_numpy(a.data.astype(np.float32)),
        size=a.shape, check_invariants=False).to(dev)


def max_abs_diff(a, b) -> float:
    """max|a - b| over the slots where they differ (equal infinities and
    NaNs in the same places count as 0)."""
    import torch
    d = (a - b).abs()
    d = torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)),
                    torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def exact(a, b) -> bool:
    """Bit for bit (signed zeros and infinities included), with NaNs in the
    same places whatever their payloads."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0.0).view(torch.int32),
        b.masked_fill(nb, 0.0).view(torch.int32)))


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def fold_bound(y, idx, ptr, long_rows, out, F: int) -> dict:
    """The fold's bound, in either layout ((n, F) or (F, n)): y, the plan
    and the output each moved once, one operation a partial and
    feature."""
    return bound(nbytes(y, idx, ptr, long_rows, out), float(F * idx.numel()))


@functools.lru_cache(maxsize=None)
def chain_clock() -> dict:
    """What the fold's chain floor is made of, measured once: the SM
    clocks of one dependent fp32 add (``_kernels.fadd_latency_cycles``,
    csrc/row_fold.cu's timer) and the card's maximum SM clock in MHz
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    from hisparse_tpu_torch.ops import _kernels
    cycles = _kernels.fadd_latency_cycles()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0])
    print(f"fold chain: one dependent fp32 add {cycles:.3f} SM clocks; "
          f"clocks.max.sm {mhz:.0f} MHz", flush=True)
    return {"fadd_cycles": cycles, "sm_max_mhz": mhz}


def chain_floor_ms(longest: int, alg: str) -> float:
    """The least time the longest plus_times row can take: its partials
    times one dependent add's latency over the SM clock (``chain_clock``);
    0 for the algebras the fold takes as a tree."""
    if alg != "plus_times":
        return 0.0
    c = chain_clock()
    return longest * c["fadd_cycles"] / (c["sm_max_mhz"] * 1e3)


def fold_record(what, op, y_ren, dev) -> dict:
    """The fold kernel on ``op``'s renamed y, ``(n,)`` or ``(n, F)`` (and
    then also its ``(F, n)`` copy): each layout bit for bit against the
    plain version and ``Wavepack.unpack_y``, and timed beside its bound
    and a PyTorch call over perm in no fixed order (``index_add_``, or
    ``scatter_reduce_`` for min and max; none for Q8.24's saturating sum);
    the plain version timed on the first layout, its longest row's range
    timed alone (one warp walking it) beside ``chain_floor_ms``."""
    import torch
    from hisparse_tpu_torch.ops.spmv import (FOLD_THREAD_MAX, algebra,
                                             row_fold, row_fold_plain)
    from hisparse_tpu_torch.utils.bench import device_time_ms
    alg = algebra(op.cfg)
    plan = (op.fold_idx, op.fold_ptr, op.fold_long)
    n = op.wp.num_rows
    F = 1 if y_ren.dim() == 1 else y_ren.shape[1]
    layouts = {"(n,)": (y_ren, -1)} if F == 1 else {
        "(n, F)": (y_ren, 0), "(F, n)": (y_ren.T.contiguous(), -1)}
    ys = y_ren.reshape(y_ren.shape[0], -1).cpu().numpy()
    if alg == "fixed":
        ys = ys.view(np.uint32)
    ref = np.stack([op.wp.unpack_y(np.ascontiguousarray(ys[:, f]))
                    for f in range(F)], 1)
    ref = torch.from_numpy(ref.view(np.int32) if alg == "fixed" else ref)
    ref = ref.to(dev).reshape((n, F) if F > 1 else (n,))
    perm = op.perm
    reduce = {"min_plus": "amin", "max_times": "amax"}.get(alg)
    rec = {"layouts": {}}
    for name, (y, dim) in layouts.items():
        out_k = row_fold(y, *plan, alg, dim)
        out_p = row_fold_plain(y, op.fold_idx, op.fold_ptr, alg, dim)
        want = ref if dim == 0 or F == 1 else ref.T
        ok = exact(out_k, out_p) and exact(out_k, want)
        check(ok, f"{what} {name}: fold kernel vs plain / unpack_y not "
              "bit-equal")
        d = 0 if dim == 0 else y.dim() - 1
        ms_k = device_time_ms(lambda: row_fold(y, *plan, alg, dim), reps=50,
                              queued=True)
        if alg == "fixed":
            ms_lib = None
        else:
            shape = list(y.shape)
            shape[d] = n + 1

            def library():
                z = torch.zeros(shape, device=dev)
                if reduce is None:
                    return z.index_add_(d, perm, y)
                index = perm.view([-1 if i == d else 1
                                   for i in range(y.dim())]).expand_as(y)
                return z.scatter_reduce_(d, index, y, reduce,
                                         include_self=False)
            ms_lib = device_time_ms(library, reps=50, queued=True)
        b = fold_bound(y, *plan, out_k, F)
        rec["layouts"][name] = {"ms": ms_k, **b, "library_ms": ms_lib,
                                "max_abs_err": max_abs_diff(out_k, out_p)}
        if "ms" not in rec:
            ms_p = device_time_ms(
                lambda: row_fold_plain(y, op.fold_idx, op.fold_ptr, alg,
                                       dim), reps=3, warmup=1)
            lengths = (op.fold_ptr[1:] - op.fold_ptr[:-1]).cpu().numpy()
            r = int(lengths.argmax())
            L = int(lengths[r])
            beg = int(op.fold_ptr[r])
            one = (op.fold_idx[beg:beg + L].contiguous(),
                   torch.tensor([0, L], dtype=torch.int32, device=dev),
                   torch.tensor([0] if L > FOLD_THREAD_MAX else [],
                                dtype=torch.int32, device=dev))
            ms_long = device_time_ms(lambda: row_fold(y, *one, alg, dim),
                                     reps=50, queued=True)
            rec.update(max_abs_err=max_abs_diff(out_k, out_p), ms=ms_k,
                       plain_ms=ms_p, **b, library_ms=ms_lib,
                       longest_row_partials=L, longest_row_ms=ms_long,
                       chain_floor_ms=chain_floor_ms(L, alg),
                       partials=int(op.fold_idx.numel()),
                       hub_rows=int(op.fold_long.numel()))
        lib = "none" if ms_lib is None else f"{ms_lib:.4f} ms"
        print(f"fold {what} {alg} {name}: {tuple(y.shape)} renamed -> {n} "
              f"rows, {op.fold_idx.numel()} partials, "
              f"{op.fold_long.numel()} hub rows of more than "
              f"{FOLD_THREAD_MAX}; kernel == plain == unpack_y {ok}; kernel "
              f"{ms_k:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), {reduce or 'index_add_'} {lib}",
              flush=True)
    print(f"fold {what}: plain {rec['plain_ms']:.4f} ms; longest row "
          f"{rec['longest_row_partials']} partials alone "
          f"{rec['longest_row_ms']:.4f} ms, chain floor "
          f"{rec['chain_floor_ms']:.4f} ms", flush=True)
    return rec


def fold_edge_checks(dev) -> int:
    """The fold kernel on the hand-made edge plan
    (``utils/bench.fold_edge_plan``) in every algebra, F = 1, 3, 16 and
    20, both layouts: bit for bit against its plain version and
    ``Wavepack.unpack_y`` (NaN payloads too for min and max, which select
    a partial); returns the comparisons made."""
    import types

    import torch
    from hisparse_tpu_torch import SpmvConfig
    from hisparse_tpu_torch.formats.wavepack import Wavepack
    from hisparse_tpu_torch.ops.spmv import (fold_plan, row_fold,
                                             row_fold_plain)
    from hisparse_tpu_torch.utils.bench import (fold_edge_plan,
                                               fold_edge_values)
    perm, n = fold_edge_plan()
    plan = [torch.from_numpy(a).to(dev) for a in fold_plan(perm, n)]
    n_cmp = 0
    for alg in ("plus_times", "min_plus", "max_times", "fixed"):
        cfg = SpmvConfig(dtype="fixed") if alg == "fixed" else SpmvConfig(
            semiring=alg)
        pk = types.SimpleNamespace(perm=perm, num_rows=n, config=cfg)
        for F in (1, 3, 16, 20):
            Y = fold_edge_values(alg, perm, F)
            ref = np.stack([Wavepack.unpack_y(pk, Y[:, f])
                            for f in range(F)], 1)
            words = Y.view(np.int32) if alg == "fixed" else Y
            y = torch.from_numpy(words).to(dev)
            ref = torch.from_numpy(ref.view(words.dtype)).to(dev)
            for y_in, dim, want in ((y, 0, ref),
                                    (y.T.contiguous(), -1, ref.T)):
                out = row_fold(y_in, *plan, alg, dim)
                plain = row_fold_plain(y_in, *plan[:2], alg, dim)
                if alg == "plus_times":
                    ok = exact(out, plain) and exact(out, want)
                else:
                    ok = torch.equal(out.view(torch.int32),
                                     plain.view(torch.int32)) and \
                        torch.equal(out.view(torch.int32),
                                    want.contiguous().view(torch.int32))
                check(ok, f"fold edge plan {alg} F={F} dim={dim}: kernel "
                      "vs plain / unpack_y not bit-equal")
                n_cmp += 2
    print(f"fold edge plan: {n_cmp} comparisons bit for bit (4 algebras, "
          "F = 1, 3, 16, 20, both layouts)", flush=True)
    return n_cmp


def natural_order_checks(what, op, x, active=None, X=None) -> int:
    """Two forwards (and, given ``active`` and ``X``, two masked calls and
    two matmul calls) bit-equal to each other in natural order and to
    ``Wavepack.unpack_y`` of the same call's renamed y; ``x`` is natural
    order (Q8.24 words for a Q8.24 pack).  Returns the comparisons made."""
    import torch
    wp = op.wp
    if op.cfg.dtype == "fixed":
        y1, y2 = op(x).numpy(), op(x).numpy()
        ren = op(x, renamed=True).view(torch.int32).cpu().numpy().view(
            np.uint32)
        ok = np.array_equal(y1, y2) and np.array_equal(y1, wp.unpack_y(ren))
        print(f"natural order {what}: forward twice == unpack_y {ok}",
              flush=True)
        check(ok, f"{what}: Q8.24 natural-order forward not fixed")
        return 2
    calls = [("forward", lambda r: op(x, renamed=r))]
    if active is not None:
        calls.append(("masked", lambda r: op.masked(x, active, renamed=r)))
    n = 0
    line = []
    for name, call in calls:
        a, b = call(False), call(False)
        ref = torch.from_numpy(wp.unpack_y(to_np(call(True)))).to(a.device)
        ok = exact(a, b) and exact(a, ref)
        line.append(f"{name} {ok}")
        check(ok, f"{what}: natural-order {name} not fixed")
        n += 2
    if X is not None:
        a, b = op.matmul(X), op.matmul(X)
        ren = to_np(op.matmul(X, renamed=True))
        ref = torch.from_numpy(np.stack([wp.unpack_y(v) for v in ren],
                                        1)).to(a.device)
        ok = exact(a, b) and exact(a, ref)
        line.append(f"matmul F={X.shape[1]} {ok}")
        check(ok, f"{what}: natural-order matmul not fixed")
        n += 2
    print(f"natural order {what}: twice and == unpack_y: " + ", ".join(line),
          flush=True)
    return n


def family_x(op, x, dev):
    """A family's x on the card in packed column order: Q8.24 words for a
    fixed-point pack."""
    import torch
    from hisparse_tpu_torch.ops.spmv import fixed_bits
    x_dev = (fixed_bits(x) if op.cfg.dtype == "fixed"
             else torch.from_numpy(x)).to(dev)
    return x_dev if op.col_order is None else x_dev[op.col_order]


def phase_families(dev) -> dict:
    """Phase 3: the SpMV kernel vs its plain version on every plus_times
    family (fp32 within TOL_PLAIN, bf16 and Q8.24 bit for bit) and the
    natural y against the golden, through ``utils/parity.spmv_family``
    (the parity sweep's own check)."""
    from hisparse_tpu_torch.utils.bench import (MULTIBLOCK_FAMILY,
                                               PLUS_TIMES_FAMILIES)
    from hisparse_tpu_torch.utils.parity import print_sweep, spmv_family
    worst, n_exact = 0.0, 0
    for fam in PLUS_TIMES_FAMILIES + (MULTIBLOCK_FAMILY,):
        rec = spmv_family(fam, dev)
        print_sweep({fam[0]: rec})
        check(rec["ok"], f"{fam[0]}: {rec}")
        if rec["tol"]["plain"] == 0.0:
            n_exact += 1
        else:
            worst = max(worst, rec["err_plain"])
    return {"worst_family_rel_err": worst,
            "bit_equal_value_type_families": n_exact}


def phase_serving(dev, kernels):
    """Phase 4: googleplus through SpmvOperator; returns (matrix, the SpMV
    kernel's record, the fold's record, launches of the path)."""
    import torch
    from hisparse_tpu_torch import SpmvConfig, SpmvOperator, pack, powerlaw_csr
    from hisparse_tpu_torch.ops.golden import spmv_f64
    from hisparse_tpu_torch.ops.spmv import spmv_tiles_plain, wavepack_spmv
    from hisparse_tpu_torch.utils.bench import device_time_ms, gbps, gops
    t0 = time.perf_counter()
    m = powerlaw_csr(*GOOGLEPLUS["shape"], seed=GOOGLEPLUS["seed"])
    t1 = time.perf_counter()
    cfg = SpmvConfig(**GOOGLEPLUS_CFG)
    wp = pack(m, cfg, **GOOGLEPLUS_PACK)
    t2 = time.perf_counter()
    print(f"googleplus: {m.num_rows}x{m.num_cols} nnz {m.nnz}; generate "
          f"{t1 - t0:.1f} s, native pack {t2 - t1:.1f} s; tiles "
          f"{wp.num_tiles}, blocks {wp.n_blocks}, parts {wp.n_parts}, fill "
          f"{wp.fill:.4f}, stream {wp.stream_bytes / 1e6:.1f} MB",
          flush=True)
    op = SpmvOperator(wp, device=dev)
    x_np = np.random.default_rng(0).random(m.num_cols).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    torch.cuda.synchronize()

    reset_counts(kernels)
    y = op(x)
    torch.cuda.synchronize()
    launches = counts(kernels)
    check(launches["wavepack_spmv"] > 0,
          "the serving path launched no wavepack_spmv kernel")

    y_np = y.cpu().numpy()
    check(y_np.shape == (m.num_rows,) and y_np.dtype == np.float32,
          f"y has shape {y_np.shape} {y_np.dtype}")
    check(bool(np.isfinite(y_np).all()), "y is not finite")
    ref = spmv_f64(m, x_np)
    err = rel_err(y_np, ref)
    print(f"googleplus: y vs spmv_f64 {err:.3e} (gate {TOL_F64}); "
          f"kernel launches {launches['wavepack_spmv']}", flush=True)
    check(err <= TOL_F64, f"googleplus y vs spmv_f64 {err}")

    args = op.stream_args(x[op.col_order])
    acc_k = wavepack_spmv(*args, cfg)
    acc_p = spmv_tiles_plain(*args, cfg)
    y_k, y_p = op.renamed_y(acc_k), op.renamed_y(acc_p)
    max_abs = float((y_k - y_p).abs().max())
    e_kp = rel_err(y_k.cpu(), y_p.cpu())
    print(f"googleplus: kernel vs plain max|dy| {max_abs:.3e}, relative "
          f"{e_kp:.3e}", flush=True)
    check(e_kp <= TOL_PLAIN, f"googleplus kernel vs plain {e_kp}")
    b = spmv_bound(args, acc_k)
    del acc_k, acc_p, y_k, y_p

    ms_k = device_time_ms(lambda: wavepack_spmv(*args, cfg), reps=50,
                          queued=True)
    # PR 1's timing, host enqueue included, beside the queued one
    ms_k_host = device_time_ms(lambda: wavepack_spmv(*args, cfg), reps=50)
    ms_p = device_time_ms(lambda: spmv_tiles_plain(*args, cfg), reps=5,
                          warmup=1)
    ms_fwd = device_time_ms(lambda: op(x), reps=50)
    a_cs = csr_tensor(m, dev)
    e_cs = rel_err(torch.mv(a_cs, x).cpu(), ref)
    ms_cs = device_time_ms(lambda: torch.mv(a_cs, x), reps=50)
    # values + column indices + row pointers, each 4 B
    csr_bytes = a_cs.values().numel() * 8 + (m.num_rows + 1) * 4
    nnz, sb = m.nnz, wp.stream_bytes
    for what, ms, nbytes in (
            ("kernel wavepack_spmv", ms_k, sb),
            ("kernel, host enqueue in", ms_k_host, sb),
            ("plain spmv_tiles_plain", ms_p, sb),
            ("forward SpmvOperator(x)", ms_fwd, sb),
            ("cuSPARSE csr @ x", ms_cs, csr_bytes)):
        print(f"time {what:24s} {ms:.4f} ms  {gops(nnz, ms):.2f} GOPS  "
              f"{gbps(nbytes, ms):.1f} GB/s of {nbytes / 1e6:.1f} MB",
              flush=True)
    print(f"cuSPARSE y vs spmv_f64 {e_cs:.3e}; kernel bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {b['bound_ms'] / ms_k:.3f}"
          f" of it", flush=True)
    record = {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p, **b,
              "library_ms": ms_cs, "ms_host_enqueue_in": ms_k_host,
              "forward_ms": ms_fwd, "pack_s": t2 - t1,
              "instantiation": instantiation(kernels, "wavepack_spmv", op)}
    # the fold on googleplus's renamed y, and natural order fixed run to
    # run: forward, masked over 10% of the columns, matmul at F = 4
    rec_fold = fold_record("googleplus", op, op(x, renamed=True), dev)
    rng = np.random.default_rng(12)
    active = np.flatnonzero(rng.random(m.num_cols) < 0.1)
    xs = torch.zeros_like(x)
    xs[torch.from_numpy(active).to(dev)] = x[torch.from_numpy(active).to(
        dev)]
    X = torch.from_numpy(rng.random((m.num_cols, 4)).astype(
        np.float32)).to(dev)
    rec_fold["natural_order_comparisons"] = natural_order_checks(
        "googleplus", op, xs, active, X)
    return m, op, record, rec_fold, launches


def phase_kernel_families(dev) -> tuple:
    """Phase 5: the gradient-stream and SpMM kernels vs their plain
    versions on the families; returns the worst relative errors."""
    import torch
    from hisparse_tpu_torch import SpmvOperator
    from hisparse_tpu_torch.ops.spmv import (
        build_xt, build_xt_multi, gradstream_tiles_plain, spmm_tiles_plain,
        wavepack_gradstream, wavepack_spmm)
    from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES,
                                               MULTIBLOCK_FAMILY,
                                               PLUS_TIMES_FAMILIES,
                                               family_case)
    worst_g = worst_s = 0.0
    for i, fam in enumerate(FP32_FAMILIES + (MULTIBLOCK_FAMILY,)):
        _, wp, x = family_case(fam)
        op = SpmvOperator(wp, device=dev, permute_x=False)
        cfg = op.cfg
        rng = np.random.default_rng(500 + i)
        mask = torch.from_numpy(
            (rng.random(op.vals.shape) < 0.8).astype(np.float32)).to(dev)
        g_acc = torch.from_numpy(rng.standard_normal(
            (wp.n_blocks * cfg.sublanes, 128)).astype(np.float32)).to(dev)
        args = (op.vals, op.idxT, mask, op.tile_part, op.tile_block,
                op.class_map, g_acc,
                build_xt(torch.from_numpy(x).to(dev), cfg, wp.n_parts), cfg)
        out_k = wavepack_gradstream(*args)
        out_p = gradstream_tiles_plain(*args)
        e_g = float((out_k - out_p).abs().max()) / max(
            float(out_p.abs().max()), 1e-30)
        worst_g = max(worst_g, e_g)
        e_s, wide = [], []
        for F in (1, 5, 16) + WIDE_FS:
            X = torch.from_numpy(rng.standard_normal(
                (wp.num_cols, F)).astype(np.float32)).to(dev)
            sargs = (op.vals, op.idxT, op.tile_part, op.class_map,
                     op.run_start, op.run_end,
                     build_xt_multi(X, cfg, wp.n_parts), cfg)
            acc_k = wavepack_spmm(*sargs, F=F)
            acc_p = spmm_tiles_plain(*sargs, F=F)
            if F in WIDE_FS:
                wide.append(exact(acc_k, acc_p))
            else:
                e_s.append(rel_err(to_np(acc_k), to_np(acc_p)))
        worst_s = max(worst_s, *e_s)
        print(f"family {fam[0]:18s} gradstream kernel-vs-plain {e_g:.3e}  "
              "spmm kernel-vs-plain F=1/5/16 "
              + " / ".join(f"{e:.3e}" for e in e_s)
              + f"; kernel==plain F={'/'.join(map(str, WIDE_FS))} {wide}",
              flush=True)
        check(e_g <= TOL_PLAIN, f"{fam[0]}: gradstream kernel vs plain {e_g}")
        check(max(e_s) <= TOL_PLAIN, f"{fam[0]}: spmm kernel vs plain {e_s}")
        check(all(wide), f"{fam[0]}: wide spmm kernel vs plain {wide}")
    # the bf16 stream through the SpMM kernel, bit for bit
    fam = next(f for f in PLUS_TIMES_FAMILIES if f[1].get("dtype") == "bf16")
    _, wp, _ = family_case(fam)
    op = SpmvOperator(wp, device=dev)
    oks = []
    for F in (1, 3, 5, 8, 16):
        X = torch.from_numpy(np.random.default_rng(F).standard_normal(
            (wp.num_cols, F)).astype(np.float32)).to(dev)
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(X, op.cfg, wp.n_parts), op.cfg)
        oks.append(exact(wavepack_spmm(*sargs, F=F),
                         spmm_tiles_plain(*sargs, F=F)))
    print(f"family {fam[0]:18s} spmm kernel==plain F=1/3/5/8/16 {oks}",
          flush=True)
    check(all(oks), f"{fam[0]}: spmm kernel vs plain {oks}")
    return worst_g, worst_s


def masked_operands(op, x_packed, active):
    """The masked kernel's operands for packed-order x and active packed
    columns."""
    return op.masked_args(x_packed, op.active_tiles(active)) + (op.cfg,)


def phase_semiring_families(dev) -> dict:
    """Phase 5, semirings and the masked kernel: on the min_plus and
    max_times families the SpMV kernel bit for bit against its plain
    version and within TOL_F64 of the float64 oracle
    (``utils/parity.spmv_family``), SpMM at F = 5 bit for bit; on every fp32 family in each semiring its config allows, the
    masked kernel bit for bit against its plain version with
    MASKED_ACTIVE active columns, and masked == full; a NaN in x in the
    same places through kernels and plain versions.  Returns the worst
    numbers."""
    import torch
    from hisparse_tpu_torch import SpmvConfig, SpmvOperator, pack, powerlaw_csr
    from hisparse_tpu_torch.ops.spmv import (
        build_xt_multi, spmm_tiles_plain, spmv_masked_tiles_plain,
        spmv_tiles_plain, wavepack_spmm, wavepack_spmv, wavepack_spmv_masked)
    from hisparse_tpu_torch.utils.bench import (
        FP32_FAMILIES, MULTIBLOCK_FAMILY, PLUS_TIMES_FAMILIES,
        SEMIRING_FAMILIES, family_case, family_inputs, sparse_x)
    from hisparse_tpu_torch.utils.parity import print_sweep, spmv_family
    worst_f64, n_exact = 0.0, 0
    for fam in SEMIRING_FAMILIES:
        rec = spmv_family(fam, dev)
        print_sweep({fam[0]: rec})
        check(rec["ok"], f"{fam[0]}: {rec}")
        _, wp, _ = family_case(fam)
        op = SpmvOperator(wp, device=dev)
        X = torch.from_numpy(np.random.default_rng(5).random(
            (wp.num_cols, 5)).astype(np.float32)).to(dev)
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(X, op.cfg, wp.n_parts), op.cfg)
        ok_m = exact(wavepack_spmm(*sargs, F=5),
                     spmm_tiles_plain(*sargs, F=5))
        print(f"family {fam[0]:22s} spmm F=5 kernel==plain {ok_m}",
              flush=True)
        check(ok_m, f"{fam[0]}: spmm kernel vs plain not bit-equal")
        worst_f64 = max(worst_f64, rec["err_f64"])
        n_exact += 2
    # the masked kernel on every fp32 family, in each semiring, and on the
    # bf16 family (plus_times only)
    bf16_fam = next(f for f in PLUS_TIMES_FAMILIES
                    if f[1].get("dtype") == "bf16")
    for fam in FP32_FAMILIES + (bf16_fam, MULTIBLOCK_FAMILY):
        args, split, _ = family_inputs(fam)
        m = powerlaw_csr(*args)
        line = []
        for sr in ("plus_times", "min_plus", "max_times"):
            if ((sr == "min_plus" and fam[1].get("steal_mantissa"))
                    or (sr != "plus_times" and fam is bf16_fam)):
                continue
            wp = pack(m, SpmvConfig(**dict(fam[1], semiring=sr)),
                      split_max=split)
            op = SpmvOperator(wp, device=dev)
            x, act = sparse_x(m.num_cols, MASKED_ACTIVE, sr, seed=3)
            x_dev = torch.from_numpy(x).to(dev)
            margs = masked_operands(op, x_dev, act)
            ok = exact(wavepack_spmv_masked(*margs),
                       spmv_masked_tiles_plain(*margs))
            same = exact(op.masked(x_dev, act), op(x_dev))
            line.append(f"{sr} {margs[2].numel()}/{wp.num_tiles} tiles "
                        f"kernel==plain {ok} masked==full {same}")
            check(ok and same, f"{fam[0]} {sr}: masked kernel {ok}, masked "
                  f"== full {same}")
            n_exact += 2
        print(f"family {fam[0]:22s} masked: " + "; ".join(line), flush=True)
    # a NaN in x through every kernel of the path, in each semiring
    base = SEMIRING_FAMILIES[2]
    m, _, x = family_case(base)
    x[m.indices[[0, m.nnz // 2]]] = np.nan    # two columns with entries
    x_dev = torch.from_numpy(x).to(dev)
    for sr in ("plus_times", "min_plus", "max_times"):
        wp = pack(m, SpmvConfig(**dict(base[1], semiring=sr)), split_max=16)
        op = SpmvOperator(wp, device=dev)
        args = op.stream_args(x_dev)
        acc = wavepack_spmv(*args, op.cfg)
        margs = masked_operands(op, x_dev, np.arange(wp.num_cols))
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(torch.stack(
                     [x_dev, x_dev.flip(0)], 1), op.cfg, wp.n_parts), op.cfg)
        oks = (exact(acc, spmv_tiles_plain(*args, op.cfg)),
               exact(wavepack_spmv_masked(*margs), acc),
               exact(spmv_masked_tiles_plain(*margs), acc),
               exact(wavepack_spmm(*sargs, F=2),
                     spmm_tiles_plain(*sargs, F=2)))
        n_nan = int(torch.isnan(acc).sum())
        print(f"NaN case {sr}: {n_nan} NaN slots; spmv, masked, masked "
              f"plain, spmm equal {oks}", flush=True)
        check(all(oks) and n_nan > 0, f"NaN case {sr}: {oks}, {n_nan}")
        n_exact += 4
    # the fold: natural order fixed run to run and equal to unpack_y on
    # the hub-split min_plus and max_times families (split_max 16) and the
    # Q8.24 family
    n_nat = 0
    for fam in SEMIRING_FAMILIES:
        m, wp, x = family_case(fam)
        op = SpmvOperator(wp, device=dev)
        sr = wp.config.semiring
        xs, act = sparse_x(m.num_cols, MASKED_ACTIVE, sr, seed=4)
        X = torch.from_numpy(np.random.default_rng(6).random(
            (wp.num_cols, 3)).astype(np.float32)).to(dev)
        n_nat += natural_order_checks(fam[0], op,
                                      torch.from_numpy(xs).to(dev), act, X)
    fam = next(f for f in PLUS_TIMES_FAMILIES if f[1].get("dtype") == "fixed")
    _, wp, x = family_case(fam)
    n_nat += natural_order_checks(fam[0], SpmvOperator(wp, device=dev), x)
    return {"worst_semiring_rel_err_f64": worst_f64,
            "bit_equal_comparisons": n_exact,
            "natural_order_comparisons": n_nat,
            "fold_edge_comparisons": fold_edge_checks(dev)}


def grad_step(sd, x, y_t, spmv_fn, gradstream_fn, r=None):
    """StreamDiffSpmv's gradient step of 0.5*|A x - y_t|^2 through
    ``spmv_fn`` and ``gradstream_fn``, the kernels' wrappers or their plain
    versions: returns y, x_bar through the A^T pack, and both gradient
    streams.  The residual r is y - y_t unless it is given."""
    from hisparse_tpu_torch.ops.train_stream import grad_stream_operands
    op, opT = sd.d.op, sd.d.opT
    vA, vT = sd.vA.detach(), sd.vT.detach()

    def spmv(o, v, vec):
        vec = vec if o.col_order is None else vec[o.col_order]
        acc = spmv_fn(*o.stream_args(vec, v), o.cfg)
        return o.unpack_device(o.renamed_y(acc))

    y = spmv(op, vA, x)
    r = y - y_t if r is None else r
    x_bar = spmv(opT, vT, r)
    gA = gradstream_fn(*grad_stream_operands(op, vA, sd.maskA, r, x))
    gT = gradstream_fn(*grad_stream_operands(opT, vT, sd.maskT, x, r))
    return y, x_bar, gA, gT


def print_profile(what: str, prof: dict, top: int = 6) -> None:
    print(f"profile {what}: event-timed {prof['ms']:.4f} ms, device busy "
          f"{prof['busy_us']:.1f} us, idle share {prof['idle_share']:.3f}",
          flush=True)
    for us, n, name in prof["ops"][:top]:
        print(f"  {us:9.1f} us {100 * us / prof['busy_us']:5.1f}% {n:5.1f}x"
              f"  {name[:90]}", flush=True)


def phase_training(dev, kernels):
    """Phase 6: transformer-70 through StreamDiffSpmv; returns the
    gradient-stream record, the SpMV kernel's comparison on the training
    packs and the launches of the path."""
    import torch
    from hisparse_tpu_torch import (SpmvConfig, StreamDiffSpmv,
                                    uniform_sparse_csr)
    from hisparse_tpu_torch.ops.spmv import (gradstream_tiles_plain,
                                             spmv_tiles_plain,
                                             wavepack_gradstream,
                                             wavepack_spmv)
    from hisparse_tpu_torch.ops.train_stream import grad_stream_operands
    from hisparse_tpu_torch.utils.bench import (device_time_ms,
                                               profile_breakdown)
    t0 = time.perf_counter()
    m = uniform_sparse_csr(*T70["shape"], seed=T70["seed"])
    t1 = time.perf_counter()
    sd = StreamDiffSpmv(m, SpmvConfig(**T70_CFG), SpmvConfig(**T70_CFG_T),
                        device=dev, split_max=None)
    t2 = time.perf_counter()
    print(f"transformer-70: {m.num_rows}x{m.num_cols} nnz {sd.m.nnz}; "
          f"generate {t1 - t0:.1f} s, pack A and A^T + maps {t2 - t1:.1f} s",
          flush=True)
    for tag, wp in (("A", sd.d.wp), ("A^T", sd.d.wpT)):
        print(f"transformer-70 pack {tag}: tiles {wp.num_tiles}, blocks "
              f"{wp.n_blocks}, parts {wp.n_parts}, fill {wp.fill:.4f}, "
              f"stream {wp.stream_bytes / 1e6:.1f} MB", flush=True)
    rng = np.random.default_rng(3)
    x_np = rng.standard_normal(sd.num_cols).astype(np.float32)
    yt_np = rng.standard_normal(sd.num_rows).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    y_t = torch.from_numpy(yt_np).to(dev)
    torch.cuda.synchronize()

    vals0 = sd.values()
    reset_counts(kernels)
    losses = []
    for step in range(T70_STEPS):
        sd.zero_grad()
        xg = x.clone().requires_grad_(True)
        y = sd(xg)
        r = y.detach() - y_t
        losses.append(float(0.5 * torch.dot(r, r)))
        y.backward(r)
        if step == 0:
            first = (to_np(y), to_np(r), to_np(xg.grad),
                     sd.vA.grad.clone(), sd.vT.grad.clone())
            rows_x = to_np(r[sd.d.rows] * x[sd.d.cols])
        sd.sgd_step(T70_LR)
        check(np.array_equal(sd.values(), sd.values_T()),
              f"transformer-70: layouts differ after step {step + 1}")
    r = sd(x).detach() - y_t
    losses.append(float(0.5 * torch.dot(r, r)))
    torch.cuda.synchronize()
    launches = counts(kernels)
    check(launches["wavepack_spmv"] > 0 and launches["wavepack_gradstream"]
          > 0, f"the training path's kernel counts {launches}")
    print(f"transformer-70: loss {' -> '.join(f'{v:.6g}' for v in losses)};"
          f" launches {launches}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"transformer-70 loss did not fall: {losses}")

    # step 1 against float64 scipy on the values the stream holds
    y0, r0, xbar0, gA0, gT0 = first
    a64 = sd.m.to_scipy().astype(np.float64)
    a64.data = vals0.astype(np.float64)
    e_y = rel_err(y0, a64 @ x_np.astype(np.float64))
    e_xb = rel_err(xbar0, a64.T @ r0.astype(np.float64))
    dA_exact = np.array_equal(sd.grads_csr(gA0), rows_x)
    print(f"transformer-70 step 1: y vs f64 {e_y:.3e}, x_bar vs f64 "
          f"{e_xb:.3e} (gate {TOL_F64}); dA == g[rows]*x[cols]: {dA_exact}",
          flush=True)
    check(e_y <= TOL_F64 and e_xb <= TOL_F64,
          f"transformer-70 step 1 vs f64: {e_y} / {e_xb}")
    check(dA_exact, "transformer-70: dA differs from g[rows]*x[cols]")

    # one DiffSpmv forward + backward on the same packs and values
    xd = x.clone().requires_grad_(True)
    yd = sd.d(xd)
    r0_dev = torch.from_numpy(r0).to(dev)
    yd.backward(r0_dev)
    e_d = max(rel_err(to_np(yd), y0), rel_err(to_np(xd.grad), xbar0),
              rel_err(to_np(sd.d.vals.grad), sd.grads_csr(gA0)))
    print(f"transformer-70: DiffSpmv vs StreamDiffSpmv {e_d:.3e} "
          f"(gate {TOL_PLAIN})", flush=True)
    check(e_d <= TOL_PLAIN, f"DiffSpmv vs StreamDiffSpmv {e_d}")

    # one gradient step through the kernels against the plain versions on
    # the same streams: y and x_bar (the SpMV kernel on the A and A^T
    # packs) within TOL_PLAIN, both gradient streams bit for bit, the
    # plain step given the kernels' residual
    y_k, xb_k, gA_k, gT_k = grad_step(sd, x, y_t, wavepack_spmv,
                                      wavepack_gradstream)
    y_p, xb_p, gA_p, gT_p = grad_step(sd, x, y_t, spmv_tiles_plain,
                                      gradstream_tiles_plain, r=y_k - y_t)
    e_ky = rel_err(to_np(y_k), to_np(y_p))
    e_kxb = rel_err(to_np(xb_k), to_np(xb_p))
    spmv_abs = max(float((y_k - y_p).abs().max()),
                   float((xb_k - xb_p).abs().max()))
    max_abs = max(float((gA_k - gA_p).abs().max()),
                  float((gT_k - gT_p).abs().max()))
    print(f"transformer-70 step, kernels vs plain: y {e_ky:.3e}, x_bar "
          f"{e_kxb:.3e} (gate {TOL_PLAIN}); gradient streams A / A^T "
          f"bit-equal {torch.equal(gA_k, gA_p)} / {torch.equal(gT_k, gT_p)}",
          flush=True)
    check(e_ky <= TOL_PLAIN and e_kxb <= TOL_PLAIN,
          f"transformer-70 SpMV kernel vs plain: y {e_ky}, x_bar {e_kxb}")
    check(torch.equal(gA_k, gA_p) and torch.equal(gT_k, gT_p),
          f"transformer-70 gradstream kernel vs plain: max|d| {max_abs}")
    del y_k, xb_k, gA_k, gT_k, y_p, xb_p, gA_p, gT_p

    # times: the gradient stream at the A pack's shape, forward, step
    gargs = grad_stream_operands(sd.d.op, sd.vA.detach(), sd.maskA, r0_dev,
                                 x)
    ms_gk = device_time_ms(lambda: wavepack_gradstream(*gargs), reps=20,
                           queued=True)
    # every operand read once, the stream-shaped output written once, two
    # products a slot
    b_g = bound(nbytes(*gargs[:-1]) + nbytes(gargs[0]),
                2.0 * gargs[0].numel())
    ms_gp = device_time_ms(lambda: gradstream_tiles_plain(*gargs), reps=5,
                           warmup=1)
    # the yardstick: cuSPARSE's SDDMM, g x^T sampled on A's CSR pattern,
    # the same dL/dvals in CSR order
    a_cs = csr_tensor(sd.m, dev)
    g_col, x_row = r0_dev[:, None], x[None, :]
    sampled = torch.sparse.sampled_addmm(a_cs, g_col, x_row, beta=0.0)
    rows_cs = torch.repeat_interleave(
        torch.arange(sd.num_rows, device=dev),
        a_cs.crow_indices().diff().long())
    d_sd = max_abs_diff(sampled.values(),
                        r0_dev[rows_cs] * x[a_cs.col_indices().long()])
    ms_gl = device_time_ms(lambda: torch.sparse.sampled_addmm(
        a_cs, g_col, x_row, beta=0.0), reps=20)
    del a_cs, sampled, rows_cs

    def fwd():
        with torch.no_grad():
            sd(x)

    def step():
        sd.zero_grad(set_to_none=True)
        xg = x.detach().requires_grad_(True)
        y = sd(xg)
        y.backward(y.detach() - y_t)

    ms_fwd = device_time_ms(fwd, reps=20)
    ms_step = device_time_ms(step, reps=20)
    ms_plain = device_time_ms(
        lambda: grad_step(sd, x, y_t, spmv_tiles_plain,
                          gradstream_tiles_plain), reps=3, warmup=1)
    nnz = sd.m.nnz
    print(f"time transformer-70 gradstream kernel {ms_gk:.4f} ms, plain "
          f"{ms_gp:.4f} ms (A pack); bound {b_g['bound_ms']:.4f} ms "
          f"({b_g['bound_by']}); torch.sparse.sampled_addmm on A's CSR "
          f"{ms_gl:.4f} ms (max|d| vs g[rows]*x[cols] {d_sd:.3e})",
          flush=True)
    print(f"time transformer-70 forward {ms_fwd:.4f} ms "
          f"({2 * nnz / ms_fwd / 1e6:.2f} GOPS); gradient step {ms_step:.4f}"
          f" ms kernels, {ms_plain:.4f} ms plain versions", flush=True)
    prof_fwd = profile_breakdown(fwd)
    print_profile("transformer-70 forward", prof_fwd)
    prof_step = profile_breakdown(step)
    print_profile("transformer-70 gradient step", prof_step)
    return {"max_abs_err": max_abs, "ms": ms_gk, "plain_ms": ms_gp, **b_g,
            "library_ms": ms_gl, "library_max_abs_diff": d_sd,
            "forward_ms": ms_fwd, "step_ms": ms_step,
            "plain_step_ms": ms_plain,
            "step_idle_share": prof_step["idle_share"]}, {
        "max_abs_err": spmv_abs, "rel_err_y": e_ky,
        "rel_err_x_bar": e_kxb}, launches


def phase_gcn(dev, kernels, m):
    """Phase 7: the GCN on googleplus; returns the SpMM record, the fold's
    record at F = 16, the launches of the path and (the GCN, its features,
    its labels) for phase 10."""
    import torch
    from hisparse_tpu_torch import GCN, SpmvConfig
    from hisparse_tpu_torch.ops.spmv import (build_xt_multi,
                                             spmm_tiles_plain, wavepack_spmm)
    from hisparse_tpu_torch.utils.bench import (device_time_ms,
                                               profile_breakdown)
    t0 = time.perf_counter()
    gcn = GCN(m, GCN_DIMS, SpmvConfig(**GOOGLEPLUS_CFG), device=dev, seed=0,
              **GOOGLEPLUS_PACK)
    print(f"gcn: normalize + pack A-hat and A-hat^T "
          f"{time.perf_counter() - t0:.1f} s; nnz {gcn.agg.m.nnz}",
          flush=True)
    for tag, wp in (("A-hat", gcn.agg.wp), ("A-hat^T", gcn.agg.wpT)):
        print(f"gcn pack {tag}: tiles {wp.num_tiles}, blocks {wp.n_blocks}, "
              f"parts {wp.n_parts}, fill {wp.fill:.4f}, stream "
              f"{wp.stream_bytes / 1e6:.1f} MB", flush=True)
    n = gcn.num_nodes
    X_np = np.random.default_rng(5).standard_normal(
        (n, GCN_DIMS[0])).astype(np.float32)
    labels = torch.from_numpy(
        np.random.default_rng(6).integers(0, GCN_DIMS[-1], n)).to(dev)
    X = torch.from_numpy(X_np).to(dev)
    torch.cuda.synchronize()

    params0 = [(to_np(w).astype(np.float64), to_np(b).astype(np.float64))
               for w, b in zip(gcn.w, gcn.b)]
    reset_counts(kernels)
    with torch.no_grad():
        logits = to_np(gcn(X))
    losses = []
    for _ in range(GCN_STEPS):
        gcn.zero_grad()
        loss = torch.nn.functional.cross_entropy(gcn(X), labels)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for p in gcn.parameters():
                p -= GCN_LR * p.grad
    with torch.no_grad():
        losses.append(float(torch.nn.functional.cross_entropy(gcn(X),
                                                              labels)))
    torch.cuda.synchronize()
    launches = counts(kernels)
    check(launches["wavepack_spmm"] > 0,
          f"the GCN path's kernel counts {launches}")

    # float64 oracle with the first forward's parameters
    a64 = gcn.agg.m.to_scipy().astype(np.float64)
    h = X_np.astype(np.float64)
    for i, (w, b) in enumerate(params0):
        h = a64 @ (h @ w) + b if GCN_DIMS[i + 1] < GCN_DIMS[i] else \
            (a64 @ h) @ w + b
        if i < len(params0) - 1:
            h = np.maximum(h, 0.0)
    e_l = rel_err(logits, h)
    print(f"gcn: logits {logits.shape} vs f64 {e_l:.3e} (gate {TOL_F64}); "
          f"loss {' -> '.join(f'{v:.6g}' for v in losses)}; launches "
          f"{launches}", flush=True)
    check(logits.shape == (n, GCN_DIMS[-1]) and np.isfinite(logits).all(),
          "gcn logits are not finite of shape (n, classes)")
    check(e_l <= TOL_F64, f"gcn logits vs f64 {e_l}")
    check(losses[-1] < losses[0], f"gcn loss did not fall: {losses}")

    def step():
        gcn.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(gcn(X), labels).backward()

    prof = profile_breakdown(step)
    print_profile("gcn training step", prof)
    # the SpMM kernel against its plain version at the path's shapes: Â
    # and Â^T at F = 8 and 16
    max_abs, by_shape = 0.0, {}
    for tag, op in (("A-hat", gcn.agg.op), ("A-hat^T", gcn.agg.opT)):
        for F in (8, 16):
            H = torch.from_numpy(np.random.default_rng(7 + F).standard_normal(
                (n, F)).astype(np.float32)).to(dev)
            if op.col_order is not None:
                H = H[op.col_order]
            sargs = (op.vals, op.idxT, op.tile_part, op.class_map,
                     op.run_start, op.run_end,
                     build_xt_multi(H, op.cfg, op.wp.n_parts), op.cfg)
            acc_k = wavepack_spmm(*sargs, F=F)
            acc_p = spmm_tiles_plain(*sargs, F=F)
            max_abs = max(max_abs, float((acc_k - acc_p).abs().max()))
            e_kp = rel_err(to_np(acc_k), to_np(acc_p))
            print(f"gcn spmm {tag} F={F}: kernel vs plain {e_kp:.3e} (gate "
                  f"{TOL_PLAIN})", flush=True)
            check(e_kp <= TOL_PLAIN, f"gcn spmm {tag} F={F} kernel vs plain "
                  f"{e_kp}")
            del acc_k, acc_p
            by_shape[tag, F] = sargs
    # times: the SpMM kernel at F = 16 on Â, the first layer's aggregation
    sargs = by_shape["A-hat", 16]
    ms_k = device_time_ms(lambda: wavepack_spmm(*sargs), reps=20,
                          queued=True)
    b_s = spmv_bound(sargs[:-1], wavepack_spmm(*sargs), F=16)
    ms_p = device_time_ms(lambda: spmm_tiles_plain(*sargs), reps=3,
                          warmup=1)
    # the yardstick: one cuSPARSE CSR SpMM of A-hat by 16 natural-order
    # features
    a_cs = csr_tensor(gcn.agg.m, dev)
    H16 = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (n, 16)).astype(np.float32)).to(dev)
    ms_cs = device_time_ms(lambda: torch.sparse.mm(a_cs, H16), reps=20)
    print(f"time gcn training step {prof['ms']:.4f} ms; spmm F=16 kernel "
          f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, cuSPARSE csr @ X {ms_cs:.4f}"
          f" ms; bound {b_s['bound_ms']:.4f} ms ({b_s['bound_by']}) (max|d| "
          f"over the four {max_abs:.3e})", flush=True)
    # the fold of A-hat's 16 renamed feature rows in both layouts: (n, F)
    # as the aggregation's natural-order matmul folds them (its renamed
    # output is that buffer's transposed view); and the natural-order
    # matmul itself (SpMM, stripe fold, fold)
    op_a = gcn.agg.op
    rec_fold = fold_record("gcn A-hat F=16", op_a,
                           op_a.matmul(H16, renamed=True).T, dev)
    Y16 = op_a.matmul(H16)
    check(Y16.shape == (n, 16) and Y16.is_contiguous(),
          f"matmul gave {tuple(Y16.shape)}, contiguous "
          f"{Y16.is_contiguous()}")
    rec_fold["matmul_natural_ms"] = device_time_ms(lambda: op_a.matmul(H16),
                                                   reps=20)
    rec_fold["gcn_step_ms"] = prof["ms"]
    print(f"time gcn A-hat matmul F=16, natural order (SpMM, stripe fold, "
          f"fold) {rec_fold['matmul_natural_ms']:.4f} ms", flush=True)
    rec_wide = wide_spmm_check(dev, kernels, gcn.agg.op)
    gcn_symmetric_check(dev, kernels)
    return {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p, **b_s,
            "library_ms": ms_cs, "gcn_step_ms": prof["ms"],
            "step_idle_share": prof["idle_share"],
            "instantiation": instantiation(kernels, "wavepack_spmm",
                                           gcn.agg.op, Fp=16),
            "wide": rec_wide}, rec_fold, launches, (gcn, X, labels)


def wide_spmm_check(dev, kernels, op) -> dict:
    """The wide SpMM instantiation on phase 7's A-hat: the kernel at F =
    64 bit for bit against its plain version, matmul at F = 100 bit for
    bit the features taken 16 at a time, the wide launches counted, and
    one wide launch timed beside the four kF = 16 launches of the same
    64 features; returns the times."""
    import torch
    from hisparse_tpu_torch.ops.spmv import (build_xt_multi,
                                             spmm_tiles_plain, wavepack_spmm)
    from hisparse_tpu_torch.utils.bench import device_time_ms
    n = op.wp.num_cols
    H = torch.from_numpy(np.random.default_rng(29).standard_normal(
        (n, 100)).astype(np.float32)).to(dev)
    stream = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
              op.run_end)
    Hp = H if op.col_order is None else H[op.col_order]
    xt = build_xt_multi(Hp[:, :SPMM_MAX_F], op.cfg, op.wp.n_parts)
    ok_plain = exact(wavepack_spmm(*stream, xt, op.cfg),
                     spmm_tiles_plain(*stream, xt, op.cfg))
    wide0, all0 = kernels.spmm_wide_launches, kernels.spmm_launches
    Y = op.matmul(H)
    n_wide = kernels.spmm_wide_launches - wide0
    n_all = kernels.spmm_launches - all0
    Y16 = torch.cat([op.matmul(H[:, f0:f0 + 16]) for f0 in range(0, 100, 16)],
                    dim=1)
    ok_chunks = exact(Y, Y16)
    xts = [build_xt_multi(Hp[:, f0:f0 + 16], op.cfg, op.wp.n_parts)
           for f0 in range(0, SPMM_MAX_F, 16)]
    ms_wide = device_time_ms(lambda: wavepack_spmm(*stream, xt, op.cfg),
                             reps=20, queued=True)
    ms_16 = device_time_ms(lambda: [wavepack_spmm(*stream, x, op.cfg)
                                    for x in xts], reps=20, queued=True)
    info = instantiation(kernels, "wavepack_spmm", op, Fp=SPMM_MAX_F)
    print(f"wide spmm A-hat F={SPMM_MAX_F}: kernel==plain {ok_plain}; "
          f"matmul F=100 == 16-feature chunks {ok_chunks}, launches {n_all} "
          f"(wide {n_wide}); time one kF={SPMM_MAX_F} launch "
          f"{ms_wide:.4f} ms, four kF=16 launches {ms_16:.4f} ms; "
          f"{info}", flush=True)
    check(ok_plain, "wide spmm kernel vs plain not bit-equal")
    check(ok_chunks, "matmul at F = 100 differs from 16-feature chunks")
    check((n_all, n_wide) == (chunks([100]), chunks([100], narrow=False)),
          f"matmul at F = 100: launches {n_all}, wide {n_wide}")
    check(info["local_bytes"] == 0, f"the wide spmm spills: {info}")
    return {"wide_ms": ms_wide, "four_kf16_ms": ms_16, **info}


def gcn_symmetric_check(dev, kernels) -> None:
    """Phase 7's GCN on a symmetric graph: one pack, the launches by
    direction, a training step against the float64 reference."""
    import scipy.sparse as sp
    import torch
    from hisparse_tpu_torch import GCN, CSRMatrix, SpmvConfig, powerlaw_csr
    from hisparse_tpu_torch.reference import gcn as ref
    a = powerlaw_csr(*APPS_100K["shape"], alpha=APPS_100K["alpha"],
                     seed=APPS_100K["seed"]).to_scipy()
    a = (a + a.T).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    a.data[:] = 1.0
    adj = CSRMatrix.from_scipy(a.astype(np.float32))
    t0 = time.perf_counter()
    gcn = GCN(adj, SYM_GCN_DIMS, SpmvConfig(), device=dev, seed=0,
              dropout=0.5, col_order="degree")
    n = gcn.num_nodes
    print(f"gcn symmetric: {n} nodes, {adj.nnz} entries; normalize, check "
          f"and pack {time.perf_counter() - t0:.1f} s; symmetric "
          f"{gcn.agg.symmetric}, tiles {gcn.agg.wp.num_tiles}", flush=True)
    check(gcn.agg.symmetric and gcn.agg.opT is gcn.agg.op
          and gcn.agg.wpT is gcn.agg.wp,
          "the symmetric GCN built a second pack")
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.standard_normal(
        (n, SYM_GCN_DIMS[0])).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, SYM_GCN_DIMS[-1], n)).to(dev)
    train = torch.from_numpy(np.sort(rng.permutation(n)[:n // 10])).to(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    state = g.get_state()
    gcn.zero_grad()
    wide0 = kernels.spmm_wide_launches
    loss = torch.nn.functional.nll_loss(torch.log_softmax(
        gcn(X, generator=g), dim=-1)[train], labels[train])
    loss.backward()
    torch.cuda.synchronize()
    launches = (gcn.agg.launches_fwd, gcn.agg.launches_bwd)
    wide = kernels.spmm_wide_launches - wide0
    g.set_state(state)
    a64 = ref.Adjacency(n, adj.indptr, adj.indices, adj.data, dev)
    want_loss, want = ref.loss_and_grads(a64, gcn.params(), X, labels,
                                         train, 0.5, g)

    def normwise(x, y) -> float:
        return float((x.double() - y).norm() / y.norm())

    # the backward product itself, A^T G through the forward's pack, at
    # the step's backward widths
    prod = {}
    for F in SYM_GCN_DIMS[2:]:
        H = torch.zeros(n, F, device=dev, requires_grad=True)
        G = torch.from_numpy(rng.standard_normal((n, F)).astype(
            np.float32)).to(dev)
        (got,) = torch.autograd.grad(gcn.agg(H), H, G)
        prod[f"A^T G F={F}"] = normwise(got, a64.AT @ G.double())
    step = {"loss": normwise(loss.detach(), want_loss)}
    for i, (w, b) in enumerate(zip(gcn.w, gcn.b)):
        step[f"w{i}"] = normwise(w.grad, want[i]["w"])
        step[f"b{i}"] = normwise(b.grad, want[i]["b"])
    print(f"gcn symmetric step: launches (fwd, bwd) {launches}, wide "
          f"{wide}; backward "
          f"products vs f64 (gate {TOL_SYM_PRODUCT}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in prod.items())
          + f"; loss and gradients vs f64 (gate {TOL_SYM_STEP}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in step.items()), flush=True)
    check(launches == SYM_GCN_LAUNCHES,
          f"the symmetric GCN step's launches {launches}")
    check(wide == chunks(SYM_GCN_FWD + SYM_GCN_BWD, narrow=False),
          f"the symmetric GCN step's wide launches {wide}")
    check(max(prod.values()) <= TOL_SYM_PRODUCT,
          f"the symmetric GCN's backward products vs f64 {prod}")
    check(max(step.values()) <= TOL_SYM_STEP,
          f"the symmetric GCN step vs f64 {step}")
    del gcn


def levels_reference(m, source: int) -> np.ndarray:
    """BFS levels by scipy's unweighted shortest paths (-1 unreachable)."""
    import scipy.sparse.csgraph as csgraph
    d = csgraph.shortest_path(m.to_scipy(), method="D", unweighted=True,
                              indices=source)
    return np.where(np.isinf(d), -1, d).astype(np.int64)


def rank_vector(app, nat, fill: float):
    """A natural-order device vector in the app's rank layout (n_slots,
    ``fill`` on the padding slots)."""
    import torch
    x = torch.full((app.n_slots,), fill, dtype=nat.dtype, device=nat.device)
    x[app.inv_t] = nat
    return x


def compare_at(what, op, x_packed, active):
    """The SpMV kernel and, given ``active``, the masked kernel against
    their plain versions on ``op``'s pack at packed-order x, bit for bit.
    Returns the operands and outputs of both."""
    from hisparse_tpu_torch.ops.spmv import (spmv_masked_tiles_plain,
                                             spmv_tiles_plain, wavepack_spmv,
                                             wavepack_spmv_masked)
    args = op.stream_args(x_packed)
    acc = wavepack_spmv(*args, op.cfg)
    plain = spmv_tiles_plain(*args, op.cfg)
    ok = exact(acc, plain)
    line = f"compare {what}: spmv kernel==plain {ok}"
    out = {"args": args, "acc": acc, "max_abs": max_abs_diff(acc, plain),
           "masked_max_abs": 0.0}
    del plain
    if active is not None:
        margs = masked_operands(op, x_packed, active)
        macc = wavepack_spmv_masked(*margs)
        mplain = spmv_masked_tiles_plain(*margs)
        ok_m = exact(macc, mplain)
        line += (f"; masked ({margs[2].numel()} of {op.wp.num_tiles} tiles)"
                 f" kernel==plain {ok_m}")
        ok = ok and ok_m
        out.update(margs=margs, macc=macc,
                   masked_max_abs=max_abs_diff(macc, mplain))
    print(line, flush=True)
    check(ok, f"{what}: kernel vs plain not bit-equal")
    return out


def fold_plain_eq(tag, app, y) -> None:
    """An app's fold of its operator's renamed y into rank order, the
    kernel against its plain version in the pack's algebra, bit for
    bit."""
    from hisparse_tpu_torch.ops.spmv import algebra, row_fold, row_fold_plain
    alg = algebra(app.wp.config)
    y = y.contiguous()
    ok = exact(row_fold(y, app.fold_idx, app.fold_ptr, app.fold_long, alg),
               row_fold_plain(y, app.fold_idx, app.fold_ptr, alg))
    print(f"{tag} fold to rank order, {alg} ({app.fold_long.numel()} ranks "
          f"of more than 32 partials): kernel==plain {ok}", flush=True)
    check(ok, f"{tag} fold to rank order: kernel vs plain not bit-equal")


def phase_apps(dev, kernels):
    """Phase 8: PageRank and BFS on the 100k power-law graph and SSSP on
    the pokec stand-in through the port's apps; returns the records of the
    SpMV and masked kernels, the launches of the path and, for phase 10,
    the two graphs, BFS's levels and SSSP's distances."""
    import torch
    from hisparse_tpu_torch import (BFS, SSSP, PageRank,
                                    normalize_by_outdegree,
                                    pagerank_reference, powerlaw_csr,
                                    rmat_csr, sssp_reference)
    from hisparse_tpu_torch.ops.spmv import (build_xt_multi,
                                             spmm_tiles_plain,
                                             spmv_masked_tiles_plain,
                                             spmv_tiles_plain, wavepack_spmm,
                                             wavepack_spmv,
                                             wavepack_spmv_masked)
    from hisparse_tpu_torch.utils.bench import (device_time_ms, gops,
                                               profile_breakdown)
    t0 = time.perf_counter()
    g = powerlaw_csr(*APPS_100K["shape"], alpha=APPS_100K["alpha"],
                     seed=APPS_100K["seed"])
    t1 = time.perf_counter()
    pr = PageRank(g, device=dev)
    t2 = time.perf_counter()
    bf = BFS(g, device=dev)
    t3 = time.perf_counter()
    m = rmat_csr(*POKEC["shape"], seed=POKEC["seed"])
    t4 = time.perf_counter()
    ss = SSSP(m, device=dev)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    print(f"apps-100k: {g.num_rows}x{g.num_cols} nnz {g.nnz}; generate "
          f"{t1 - t0:.1f} s; PageRank pack + fold plan {t2 - t1:.1f} s, BFS "
          f"{t3 - t2:.1f} s", flush=True)
    print(f"pokec: {m.num_rows}x{m.num_cols} nnz {m.nnz}; generate "
          f"{t4 - t3:.1f} s, SSSP transpose + pack + fold plan + upload "
          f"{t5 - t4:.1f} s", flush=True)
    for tag, app in (("pagerank", pr), ("bfs", bf), ("sssp", ss)):
        wp = app.wp
        print(f"{tag} pack: tiles {wp.num_tiles}, blocks {wp.n_blocks}, "
              f"parts {wp.n_parts}, fill {wp.fill:.4f}, stream "
              f"{wp.stream_bytes / 1e6:.1f} MB; fold: {app.n} ranks, "
              f"{app.fold_long.numel()} of more than 32 partials", flush=True)

    # the main path, counted: every app run
    reset_counts(kernels)
    w0 = time.perf_counter()
    r = pr.run(iters=PR_ITERS)
    torch.cuda.synchronize()
    w1 = time.perf_counter()
    lv_d = bf.run(source=0)
    w2 = time.perf_counter()
    bfs_iters = int(lv_d.max()) + 1
    lv_m = bf.run(source=0, masked=True)
    bfs_tiles = list(bf.tiles_streamed)
    w3 = time.perf_counter()
    d_d = ss.run(source=0)
    torch.cuda.synchronize()
    w4 = time.perf_counter()
    it_d = ss.iters_run
    d_m = ss.run(source=0, masked=True)
    torch.cuda.synchronize()
    w5 = time.perf_counter()
    it_m, sssp_tiles = ss.iters_run, list(ss.tiles_streamed)
    launches = counts(kernels)
    check(launches["wavepack_spmv"] > 0
          and launches["wavepack_spmv_masked"] > 0
          and launches["row_fold"] == launches["wavepack_spmv"]
          + launches["wavepack_spmv_masked"],
          f"the apps path's kernel counts {launches}")
    print(f"apps: launches {launches}", flush=True)

    # PageRank against the golden, the metric of bench.py:751
    r = to_np(r)
    ref = pagerank_reference(g, iters=PR_ITERS)
    e_pr = float(np.abs(r - ref).max() / np.abs(ref).max())
    print(f"pagerank-100k: {PR_ITERS} iterations in {w1 - w0:.3f} s; "
          f"max|r - ref| / max|ref| {e_pr:.3e} (gate {TOL_F64})", flush=True)
    check(r.shape == (g.num_rows,) and np.isfinite(r).all(),
          "pagerank result is not finite of shape (n,)")
    check(e_pr <= TOL_F64, f"pagerank vs reference {e_pr}")
    # BFS against scipy's levels, masked against dense
    lv_d, lv_m = to_np(lv_d), to_np(lv_m)
    lv_ref = levels_reference(g, 0)
    print(f"bfs-100k: depth {lv_d.max()}, reached {(lv_d >= 0).mean():.4f}; "
          f"dense {bfs_iters} iterations in {w2 - w1:.3f} s, masked in "
          f"{w3 - w2:.3f} s, tiles streamed {bfs_tiles} of "
          f"{bf.wp.num_tiles}; levels == scipy {np.array_equal(lv_d, lv_ref)}"
          f", masked == dense {np.array_equal(lv_m, lv_d)}", flush=True)
    check(np.array_equal(lv_d, lv_ref), "bfs levels differ from scipy's")
    check(np.array_equal(lv_m, lv_d), "masked bfs differs from dense")
    # SSSP against Dijkstra, masked against dense
    t0 = time.perf_counter()
    dist_ref = sssp_reference(m, 0)
    t_dij = time.perf_counter() - t0
    d_d, d_m = to_np(d_d), to_np(d_m)
    fin = np.isfinite(dist_ref)
    e_ss = float((np.abs(d_d[fin] - dist_ref[fin])
                  / np.maximum(np.abs(dist_ref[fin]), 1.0)).max())
    same_unreached = bool((np.isfinite(d_d) == fin).all())
    print(f"sssp-pokec: reach {fin.mean():.4f}; dense {it_d} iterations in "
          f"{w4 - w3:.3f} s ({1e3 * (w4 - w3) / it_d:.3f} ms/iteration), "
          f"masked {it_m} in {w5 - w4:.3f} s ({1e3 * (w5 - w4) / it_m:.3f} "
          f"ms/iteration); Dijkstra {t_dij:.1f} s; vs Dijkstra {e_ss:.3e} "
          f"(gate {TOL_F64}), same unreachable {same_unreached}, masked == "
          f"dense {np.array_equal(d_m, d_d)}", flush=True)
    print(f"sssp-pokec masked tiles per iteration (of {ss.wp.num_tiles}): "
          f"{sssp_tiles}", flush=True)
    check(e_ss <= TOL_F64 and same_unreached, f"sssp vs Dijkstra {e_ss}")
    check(np.array_equal(d_m, d_d), "masked sssp differs from dense")

    # the kernels against their plain versions at every shape of the path
    x_pr = torch.full((pr.n_slots,), 1.0 / pr.n, device=dev)
    x_pr = pr.step(pr.step(x_pr))
    cmps = [compare_at("pagerank pack", pr.op, x_pr[:pr.n], None)]
    k_bfs = max(1, int(lv_d.max()) // 2)
    front_nat = torch.from_numpy((lv_d == k_bfs).astype(np.float32)).to(dev)
    f_rank = rank_vector(bf, front_nat, 0.0)
    cmps.append(compare_at(f"bfs pack at the level-{k_bfs} frontier "
                           f"({int(front_nat.sum())} vertices)", bf.op,
                           f_rank[:bf.n], bf.inv[lv_d == k_bfs]))
    # the fold into rank order against its plain version, on PageRank's
    # and BFS's renamed y (SSSP's below, with its step)
    for tag, app, x in (("pagerank", pr, x_pr), ("bfs", bf, f_rank)):
        fold_plain_eq(tag, app, app.op(x[:app.n], renamed=True))
    k = max(1, it_d // 2)
    d_k = ss.run(source=0, iters=k)
    d_k1 = ss.run(source=0, iters=k - 1)
    changed = to_np(d_k < d_k1)
    x_ss = rank_vector(ss, d_k, float("inf"))
    act = ss.inv[np.flatnonzero(changed)]
    t0 = time.perf_counter()
    tiles = ss.op.active_tiles(act)
    t_sel = time.perf_counter() - t0
    cmp_ss = compare_at(f"sssp pokec pack at iteration {k}'s frontier "
                        f"({len(act)} vertices)", ss.op, x_ss[:ss.n], act)
    cmps.append(cmp_ss)
    torch.cuda.synchronize()
    # masked host cost: the tile selection, and a masked call's enqueue
    t0 = time.perf_counter()
    ss.op.masked_tiles(x_ss[:ss.n], tiles, renamed=True)
    t_call = time.perf_counter() - t0
    torch.cuda.synchronize()
    print(f"sssp masked host: active_tiles {1e3 * t_sel:.3f} ms, masked "
          f"call enqueue {1e3 * t_call:.3f} ms", flush=True)
    # one SSSP step: one SpMV launch and one fold into rank order, no
    # selection SpMVs; the fold against its plain version
    before = counts(kernels)
    ss.step(x_ss)
    torch.cuda.synchronize()
    after = counts(kernels)
    step_l = {k: after[k] - before[k] for k in after}
    print(f"sssp-pokec step launches {step_l}", flush=True)
    check(step_l["wavepack_spmv"] == 1 and step_l["row_fold"] == 1
          and sum(step_l.values()) == 2,
          f"an SSSP step's launches {step_l}")
    fold_plain_eq("sssp-pokec", ss, ss.op(x_ss[:ss.n], renamed=True))

    # times: the kernels on the pokec pack, queued, beside their bounds
    args, acc = cmp_ss["args"], cmp_ss["acc"]
    margs, macc = cmp_ss["margs"], cmp_ss["macc"]
    ms_k = device_time_ms(lambda: wavepack_spmv(*args, ss.op.cfg), reps=10,
                          queued=True)
    ms_p = device_time_ms(lambda: spmv_tiles_plain(*args, ss.op.cfg), reps=2,
                          warmup=1)
    ms_mk = device_time_ms(lambda: wavepack_spmv_masked(*margs), reps=10,
                           queued=True)
    ms_mp = device_time_ms(lambda: spmv_masked_tiles_plain(*margs), reps=2,
                           warmup=1)
    b_k, b_m = spmv_bound(args, acc), masked_bound(margs, macc)
    for what, ms, b in (("spmv kernel, pokec", ms_k, b_k),
                        ("spmv plain, pokec", ms_p, b_k),
                        ("masked kernel, pokec frontier", ms_mk, b_m),
                        ("masked plain, pokec frontier", ms_mp, b_m)):
        print(f"time {what:30s} {ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), {b['bound_ms'] / ms:.3f} of it",
              flush=True)
    # whole steps and iterations
    ms_pr = device_time_ms(lambda: pr.step(x_pr), reps=20)
    a_pr = csr_tensor(normalize_by_outdegree(g.astype(np.float32)), dev)
    x_cs = torch.from_numpy(r).to(dev)
    ms_cs = device_time_ms(lambda: torch.mv(a_pr, x_cs), reps=20)
    reached = rank_vector(bf, torch.from_numpy(
        ((lv_d >= 0) & (lv_d <= k_bfs)).astype(np.float32)).to(dev), 0.0)
    frontier = f_rank
    ms_bfs = device_time_ms(lambda: bf.step(frontier, reached), reps=20)
    ms_ss = device_time_ms(lambda: ss.step(x_ss), reps=10)

    def masked_step():
        y, _ = ss.spmv_masked(x_ss, act)
        return torch.minimum(x_ss, y)

    ms_ssm = device_time_ms(masked_step, reps=10)
    print(f"time pagerank-100k step {ms_pr:.4f} ms/iteration "
          f"({gops(g.nnz, ms_pr):.2f} GOPS); cuSPARSE csr @ x on the "
          f"normalised matrix {ms_cs:.4f} ms ({gops(g.nnz, ms_cs):.2f} GOPS)",
          flush=True)
    # the paged (multi-partition) kernels on the PageRank pack: SpMV and
    # SpMM at F = 16, beside their bounds and cuSPARSE on the same matrix
    op_pr, args_pr = pr.op, cmps[0]["args"]
    ms_pk = device_time_ms(lambda: wavepack_spmv(*args_pr, op_pr.cfg),
                           reps=50, queued=True)
    b_pk = spmv_bound(args_pr, cmps[0]["acc"])
    H16 = torch.from_numpy(np.random.default_rng(29).standard_normal(
        (g.num_cols, 16)).astype(np.float32)).to(dev)
    H16p = H16 if op_pr.col_order is None else H16[op_pr.col_order]
    sargs = (op_pr.vals, op_pr.idxT, op_pr.tile_part, op_pr.class_map,
             op_pr.run_start, op_pr.run_end,
             build_xt_multi(H16p, op_pr.cfg, op_pr.wp.n_parts), op_pr.cfg)
    acc_sk, acc_sp = wavepack_spmm(*sargs), spmm_tiles_plain(*sargs)
    e_s = rel_err(to_np(acc_sk), to_np(acc_sp))
    check(e_s <= TOL_PLAIN, f"pagerank pack spmm F=16 kernel vs plain {e_s}")
    ms_sk = device_time_ms(lambda: wavepack_spmm(*sargs), reps=20,
                           queued=True)
    ms_sp = device_time_ms(lambda: spmm_tiles_plain(*sargs), reps=2,
                           warmup=1)
    b_sk = spmv_bound(sargs[:-1], acc_sk, F=16)
    ms_scs = device_time_ms(lambda: torch.sparse.mm(a_pr, H16), reps=20)
    print(f"time paged kernels, pagerank pack ({op_pr.wp.n_parts} "
          f"partitions): spmv {ms_pk:.4f} ms (bound {b_pk['bound_ms']:.4f} "
          f"ms, cuSPARSE csr @ x {ms_cs:.4f} ms); spmm F=16 {ms_sk:.4f} ms "
          f"(bound {b_sk['bound_ms']:.4f} ms {b_sk['bound_by']}, plain "
          f"{ms_sp:.4f} ms, cuSPARSE csr @ X {ms_scs:.4f} ms; kernel vs plain"
          f" {e_s:.3e})", flush=True)
    rec_spmm_paged = {"pagerank_pack_f16_ms": ms_sk,
                      "pagerank_pack_f16_plain_ms": ms_sp,
                      "pagerank_pack_f16_bound_ms": b_sk["bound_ms"],
                      "pagerank_pack_f16_cusparse_ms": ms_scs,
                      "pagerank_pack_parts": op_pr.wp.n_parts,
                      "pagerank_pack_f16_max_abs_err": float(
                          (acc_sk - acc_sp).abs().max())}
    del acc_sk, acc_sp
    print(f"time bfs-100k dense step {ms_bfs:.4f} ms; sssp-pokec dense step "
          f"{ms_ss:.4f} ms ({gops(m.nnz, ms_ss):.2f} GOPS), masked step at "
          f"iteration {k}'s frontier {ms_ssm:.4f} ms", flush=True)
    for what, fn in (("sssp-pokec dense step", lambda: ss.step(x_ss)),
                     ("sssp-pokec masked step", masked_step),
                     ("bfs-100k dense step",
                      lambda: bf.step(frontier, reached))):
        print_profile(what, profile_breakdown(fn, steps=5))
    rec_spmv = {"max_abs_err": max(c["max_abs"] for c in cmps),
                "pokec_ms": ms_k, "pokec_plain_ms": ms_p,
                "pokec_bound_ms": b_k["bound_ms"], "pagerank_step_ms": ms_pr,
                "pagerank_cusparse_ms": ms_cs, "sssp_step_ms": ms_ss,
                "bfs_step_ms": ms_bfs, "sssp_iterations": it_d,
                "pagerank_rel_err": e_pr, "sssp_rel_err": e_ss,
                "pokec_instantiation": instantiation(
                    kernels, "wavepack_spmv", ss.op),
                "pagerank_pack_ms": ms_pk,
                "pagerank_pack_bound_ms": b_pk["bound_ms"],
                "pagerank_pack_parts": op_pr.wp.n_parts}
    rec_masked = {"max_abs_err": max(c["masked_max_abs"] for c in cmps),
                  "ms": ms_mk, "plain_ms": ms_mp,
                  **b_m, "library_ms": None,
                  "instantiation": instantiation(
                      kernels, "wavepack_spmv_masked", ss.op),
                  "tiles": int(margs[2].numel()),
                  "of_tiles": ss.wp.num_tiles,
                  "sssp_masked_step_ms": ms_ssm,
                  "sssp_tiles_per_iteration": sssp_tiles,
                  "bfs_tiles_per_iteration": bfs_tiles}
    return rec_spmv, rec_masked, rec_spmm_paged, launches, {
        "graph": g, "pokec": m, "bfs_levels": lv_d, "sssp_dist": d_d}


def f64_bcsr(op, X):
    """A float64 Y = A X on the card from the operator's blocks as stored
    (rounded to their dtype) and X rounded to that dtype, block products
    in chunks of 512 blocks: the reference of the BCSR checks."""
    import torch
    from hisparse_tpu_torch.ops.bcsr import BS
    xp = op.padded_x(X).double()
    k = xp.shape[1]
    brow = torch.repeat_interleave(
        torch.arange(op.nbr, device=xp.device),
        (op.brow_ptr[1:] - op.brow_ptr[:-1]).long())
    xb = xp.reshape(-1, BS, k)
    out = torch.zeros(op.nbr, BS, k, dtype=torch.float64, device=xp.device)
    for c0 in range(0, op.blocks.shape[0], 512):
        sl = slice(c0, c0 + 512)
        out.index_add_(0, brow[sl], torch.bmm(op.blocks[sl].double(),
                                              xb[op.bcol[sl].long()]))
    return out.reshape(op.nbr * BS, k)[:op.num_rows, :X.shape[1]]


def max_rel(a, b) -> float:
    """max|a - b| / max|b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def phase_dispatch(dev, kernels, m_gplus):
    """Phase 9: the format dispatch at the suite's sizes; returns the BCSR
    kernel's record, the dispatch rows' record, the launches of the path
    and the fixed row's matrix and x for phase 10."""
    import dataclasses
    import torch
    from hisparse_tpu_torch import (BcsrOperator, DenseOperator, SpmmOperator,
                                    SpmvConfig, SpmvOperator,
                                    block_structured_csr, choose_format,
                                    pack, uniform_sparse_csr)
    from hisparse_tpu_torch.ops.bcsr import bcsr_plain, bcsr_spmm
    from hisparse_tpu_torch.ops.dense import dense_mm, format_times
    from hisparse_tpu_torch.ops.golden import (float_to_fixed, spmv_f64,
                                               spmv_fixed_vec)
    from hisparse_tpu_torch.ops.spmv import spmv_tiles_plain, wavepack_spmv
    from hisparse_tpu_torch.utils.bench import (device_time_ms, gbps, gops,
                                               profile_breakdown)
    t0 = time.perf_counter()
    m_b = block_structured_csr(*BCSR16K["shape"],
                               block_rows=BCSR16K["block_rows"],
                               seed=BCSR16K["seed"])
    mats = [("bcsr-spmm-16k", m_b)]
    for pct in TRANSFORMER_PCTS:
        d = (100 - pct) / 100.0
        mats.append((f"transformer_{pct}",
                     uniform_sparse_csr(512, 33288, int(33288 * d),
                                        seed=pct)))
    mats.append(("googleplus", m_gplus))
    m_f = uniform_sparse_csr(*FIXED_ROW["shape"], seed=FIXED_ROW["seed"])
    # scaled so that no row sum saturates (bench.py:420-425)
    m_f = dataclasses.replace(m_f, data=float_to_fixed(
        np.abs(m_f.data) / (4 * m_f.nnz / m_f.num_rows)))
    t1 = time.perf_counter()
    wp_f = pack(m_f, SpmvConfig(**FIXED_CFG), **FIXED_PACK)
    t2 = time.perf_counter()
    print(f"dispatch: generate {t1 - t0:.1f} s; fixed row "
          f"{m_f.num_rows}x{m_f.num_cols} nnz {m_f.nnz}, pack {t2 - t1:.1f} "
          f"s: tiles {wp_f.num_tiles}, blocks {wp_f.n_blocks}, parts "
          f"{wp_f.n_parts}, fill {wp_f.fill:.4f}, stream "
          f"{wp_f.stream_bytes / 1e6:.1f} MB", flush=True)

    # the dispatch on the card's committed rates
    picks = {}
    for name, m in mats:
        tc = time.perf_counter()
        picks[name] = choose_format(m)
        dt = time.perf_counter() - tc
        t = format_times(m, calibrate=False)
        print(f"choose_format {name}: {m.num_rows}x{m.num_cols} nnz {m.nnz} "
              f"density {m.nnz / (m.num_rows * m.num_cols):.4f} -> "
              f"{picks[name]} ({dt:.2f} s); ns/nnz before calibration: "
              + ", ".join(f"{k} {v:.5f}" for k, v in t.items()), flush=True)
    check(picks["bcsr-spmm-16k"] == "bcsr",
          f"choose_format sends bcsr-spmm-16k to {picks['bcsr-spmm-16k']}")

    # the operators of the path: bcsr-spmm-16k through BcsrOperator (bf16,
    # bench.py:906, whatever the pick, as bench.py's row runs it), each
    # transformer matrix that the dispatch sends to dense through
    # DenseOperator (bf16, bench.py:563), the fixed row through
    # SpmvOperator
    op_b = BcsrOperator(m_b, torch.bfloat16, device=dev)
    X = torch.from_numpy(np.random.default_rng(1).random(
        (m_b.num_cols, BCSR_RHS)).astype(np.float32)).to(dev)
    dense = {name: (m, DenseOperator(m, "bf16", device=dev))
             for name, m in mats
             if name.startswith("transformer") and picks[name] == "dense"}
    x_t = torch.from_numpy(np.random.default_rng(0).random(33288).astype(
        np.float32)).to(dev)
    op_f = SpmvOperator(wp_f, device=dev)
    x_f = float_to_fixed(np.random.default_rng(0).random(
        m_f.num_cols).astype(np.float32))
    print(f"bcsr-spmm-16k: {op_b.blocks.shape[0]} blocks of 128x128, block "
          f"fill {op_b.block_fill:.4f}, {op_b.stream_bytes / 1e6:.1f} MB in "
          f"bf16; dense picks {sorted(dense)}", flush=True)
    torch.cuda.synchronize()

    # the main path, counted
    reset_counts(kernels)
    y_f = op_f(x_f)
    Y = op_b(X)
    ys = {name: op(x_t) for name, (_, op) in dense.items()}
    torch.cuda.synchronize()
    launches = counts(kernels)
    print(f"dispatch: launches {launches}", flush=True)
    check(launches["bcsr"] > 0 and launches["wavepack_spmv"] > 0,
          f"the dispatch path's kernel counts {launches}")

    # the fixed row: bit for bit
    ref_f = spmv_fixed_vec(m_f, x_f, m_f.data)
    ok_f = bool(np.array_equal(y_f.numpy(), ref_f))
    args_f = op_f.stream_args(family_x(op_f, x_f, dev))
    acc_f = wavepack_spmv(*args_f, op_f.cfg)
    ok_fk = exact(acc_f, spmv_tiles_plain(*args_f, op_f.cfg))
    print(f"fixed row: y == spmv_fixed_vec {ok_f}; kernel == plain {ok_fk}",
          flush=True)
    check(ok_f and ok_fk, f"fixed row: y {ok_f}, kernel vs plain {ok_fk}")
    n_nat = natural_order_checks("fixed row", op_f, x_f)
    rec_fold_f = fold_record("fixed row", op_f,
                             op_f(x_f, renamed=True).view(torch.int32), dev)

    # bcsr-spmm-16k against float64 and the plain version
    check(Y.shape == (m_b.num_rows, BCSR_RHS) and bool(
        torch.isfinite(Y).all()), f"bcsr Y {tuple(Y.shape)} not finite")
    e_y = max_rel(Y, f64_bcsr(op_b, X))
    xp = op_b.padded_x(X)
    bargs = (op_b.blocks, op_b.brow_ptr, op_b.bcol, xp)
    out_k, out_p = bcsr_spmm(*bargs), bcsr_plain(*bargs)
    max_abs_b = float((out_k - out_p).abs().max())
    e_kp = max_abs_b / float(out_p.abs().max())
    print(f"bcsr-spmm-16k bf16: Y vs f64 of the rounded operands {e_y:.3e}, "
          f"kernel vs plain max|d| {max_abs_b:.3e} = {e_kp:.3e} of max|Y| "
          f"(gates {TOL_F64})", flush=True)
    check(e_y <= TOL_F64 and e_kp <= TOL_F64,
          f"bcsr bf16: vs f64 {e_y}, kernel vs plain {e_kp}")
    op_b32 = BcsrOperator(m_b, torch.float32, device=dev)
    e_32 = {}
    for k in (1, BCSR_RHS):
        Xk = X[:, :k]
        Yk = op_b32(Xk[:, 0] if k == 1 else Xk)
        e_32[k] = max_rel(Yk.reshape(m_b.num_rows, k), f64_bcsr(op_b32, Xk))
    print(f"bcsr-spmm-16k fp32 blocks: vs f64 k=1 {e_32[1]:.3e}, k={BCSR_RHS} "
          f"{e_32[BCSR_RHS]:.3e} (gate {TOL_F64})", flush=True)
    check(max(e_32.values()) <= TOL_F64, f"bcsr fp32 vs f64 {e_32}")
    del op_b32

    # the dense picks against float64 of the rounded operands
    e_d = {}
    for name, (m, op) in dense.items():
        xp_d = op.padded(x_t)
        ref = (op.a.double() @ xp_d.double())[:m.num_rows, 0]
        e_d[name] = max_rel(ys[name], ref)
    print("dense picks vs f64 of the rounded operands: "
          + ", ".join(f"{k} {v:.3e}" for k, v in e_d.items()), flush=True)
    check(all(v <= TOL_F64 for v in e_d.values()), f"dense vs f64 {e_d}")

    # times: the BCSR kernel beside its bound and the yardsticks
    ms_bk = device_time_ms(lambda: bcsr_spmm(*bargs), reps=20, queued=True)
    ms_bp = device_time_ms(lambda: bcsr_plain(*bargs), reps=3, warmup=1)
    nb = op_b.blocks.shape[0]
    b_b = bound(nbytes(*bargs, out_k), 2.0 * nb * 128 * 128 * BCSR_RHS,
                "bf16_tensor")
    a_cs = csr_tensor(m_b, dev)
    ms_cs = device_time_ms(lambda: torch.sparse.mm(a_cs, X), reps=20)
    bsr = torch.sparse_bsr_tensor(op_b.brow_ptr.long(), op_b.bcol.long(),
                                  op_b.blocks, size=(op_b.nbr * 128,
                                                     op_b.nbc * 128),
                                  check_invariants=False)
    e_bsr = max_rel((bsr @ xp)[:m_b.num_rows, :BCSR_RHS].float(), out_p[
        :m_b.num_rows, :BCSR_RHS])
    ms_bsr = device_time_ms(lambda: bsr @ xp, reps=20)
    del a_cs, bsr
    # the dense arm on the same product, the dispatch's other candidate
    op_sd = SpmmOperator(m_b, "bf16", device=dev)
    e_sd = max_rel(op_sd(X), out_p[:m_b.num_rows, :BCSR_RHS])
    ms_sd = device_time_ms(lambda: op_sd(X), reps=20)
    b_sd = bound(op_sd.inner.stream_bytes + nbytes(X) // 2
                 + nbytes(out_p), 2.0 * op_sd.inner.a.numel() * BCSR_RHS,
                 "bf16_tensor")
    # the picked arm's forward against the dense arm's, each as a user
    # calls it and as device time (queued: the host's enqueue, which
    # both forwards wait on and which varies with the host, held out)
    ms_bf = device_time_ms(lambda: op_b(X), reps=20)
    ms_bfq = device_time_ms(lambda: op_b(X), reps=20, queued=True)
    ms_sdq = device_time_ms(lambda: op_sd(X), reps=20, queued=True)
    del op_sd
    print(f"time bcsr-spmm-16k dense arm (SpmmOperator bf16, "
          f"{m_b.num_rows}x{m_b.num_cols}): {ms_sd:.4f} ms ({ms_sdq:.4f} "
          f"queued), bound {b_sd['bound_ms']:.4f} ms ({b_sd['bound_by']}); "
          f"vs the BCSR plain version {e_sd:.2e}; the BCSR arm's forward "
          f"(BcsrOperator bf16) {ms_bf:.4f} ms ({ms_bfq:.4f} queued)",
          flush=True)
    check(ms_bfq < ms_sdq, f"bcsr-spmm-16k: the picked BCSR arm "
          f"({ms_bfq:.4f} ms of device time) is not the faster measured arm "
          f"(dense {ms_sdq:.4f} ms)")
    print(f"time bcsr-spmm-16k ({BCSR_RHS} rhs): kernel {ms_bk:.4f} ms "
          f"({gops(m_b.nnz * BCSR_RHS, ms_bk):.1f} GOPS of the true nonzeros,"
          f" {gbps(op_b.stream_bytes, ms_bk):.1f} GB/s of blocks); bound "
          f"{b_b['bound_ms']:.4f} ms ({b_b['bound_by']}), "
          f"{b_b['bound_ms'] / ms_bk:.3f} of it; plain {ms_bp:.4f} ms; "
          f"cuSPARSE csr fp32 @ X {ms_cs:.4f} ms; torch bsr bf16 @ X "
          f"{ms_bsr:.4f} ms (vs plain {e_bsr:.2e})", flush=True)

    # times: the fixed row's kernel
    ms_fk = device_time_ms(lambda: wavepack_spmv(*args_f, op_f.cfg), reps=50,
                           queued=True)
    ms_fp = device_time_ms(lambda: spmv_tiles_plain(*args_f, op_f.cfg),
                           reps=3, warmup=1)
    ms_ff = device_time_ms(lambda: op_f(x_f), reps=20)
    print_profile("fixed row forward", profile_breakdown(lambda: op_f(x_f)))
    b_f = spmv_bound(args_f, acc_f)
    print(f"time fixed row: kernel {ms_fk:.4f} ms ({gops(m_f.nnz, ms_fk):.2f}"
          f" GOPS, {gbps(wp_f.stream_bytes, ms_fk):.1f} GB/s); bound "
          f"{b_f['bound_ms']:.4f} ms ({b_f['bound_by']}), "
          f"{b_f['bound_ms'] / ms_fk:.3f} of it; plain {ms_fp:.4f} ms; "
          f"forward (device fold, one copy to the host) {ms_ff:.4f} ms",
          flush=True)

    # times: each dense pick's forward beside its bound and the wavepack
    # forward of the same matrix
    rows = {}
    for name, (m, op) in dense.items():
        xp_d = op.padded(x_t)
        ms_dk = device_time_ms(lambda: dense_mm(op.a, xp_d), reps=50,
                               queued=True)
        ms_df = device_time_ms(lambda: op(x_t), reps=50)
        b_d = bound(op.stream_bytes + nbytes(xp_d) + 4 * op.a.shape[0],
                    2.0 * op.a.numel(), "bf16_tensor")
        # the wavepack forward at the transformer-70 training row's config
        tp = time.perf_counter()
        op_w = SpmvOperator(pack(m, SpmvConfig(**T70_CFG)), device=dev)
        t_pack = time.perf_counter() - tp
        e_w = rel_err(to_np(op_w(x_t)), spmv_f64(m, to_np(x_t)))
        check(e_w <= TOL_F64, f"{name} wavepack forward vs f64 {e_w}")
        ms_w = device_time_ms(lambda: op_w(x_t), reps=50)
        rows[name] = {"dense_mm_ms": ms_dk, "dense_forward_ms": ms_df,
                      "dense_bound_ms": b_d["bound_ms"],
                      "wavepack_forward_ms": ms_w,
                      "wavepack_stream_mb": op_w.wp.stream_bytes / 1e6}
        print(f"time {name} dense bf16: mm {ms_dk:.4f} ms, forward "
              f"{ms_df:.4f} ms ({gops(m.nnz, ms_df):.1f} GOPS), bound "
              f"{b_d['bound_ms']:.4f} ms ({b_d['bound_by']}); wavepack "
              f"forward {ms_w:.4f} ms ({gops(m.nnz, ms_w):.1f} GOPS, "
              f"{op_w.wp.stream_bytes / 1e6:.1f} MB, pack {t_pack:.1f} s, "
              f"vs f64 {e_w:.2e})", flush=True)
        del op_w
    rec_bcsr = {"max_abs_err": max_abs_b, "ms": ms_bk, "plain_ms": ms_bp,
                **b_b, "library_ms": ms_cs, "library_bsr_bf16_ms": ms_bsr,
                "rel_err_kernel_vs_plain": e_kp, "rel_err_f64": e_y,
                "dense_arm_ms": ms_sd, "dense_arm_bound_ms": b_sd["bound_ms"],
                "forward_ms": ms_bf, "forward_queued_ms": ms_bfq,
                "dense_arm_queued_ms": ms_sdq,
                "fp32_rel_err_f64": {str(k): v for k, v in e_32.items()},
                "blocks": nb, "block_fill": op_b.block_fill}
    rec_rows = {"picks": picks, "fixed_row_ms": ms_fk,
                "fixed_row_plain_ms": ms_fp, "fixed_row_forward_ms": ms_ff,
                "fixed_row_bound_ms": b_f["bound_ms"],
                "fixed_row_gops": gops(m_f.nnz, ms_fk), "dense": rows,
                "fixed_row_natural_order_comparisons": n_nat,
                "fold_fixed_row": rec_fold_f}
    return rec_bcsr, rec_rows, launches, (m_f, x_f)


def phase_mesh(dev, kernels, m_gplus, gcn_ctx, apps, fixed):
    """Phase 10: the mesh on one card, four shards on ``dev``, through
    ``hisparse_tpu_torch.parallel``; returns the launches of the path and
    the phase's record."""
    import dataclasses

    import torch
    from hisparse_tpu_torch import (SpmvConfig, SpmvOperator, StreamDiffSpmv,
                                    pack, pagerank_reference,
                                    uniform_sparse_csr)
    from hisparse_tpu_torch.ops.golden import spmv_f64, spmv_fixed_vec
    from hisparse_tpu_torch.ops.spmv import (
        build_xt_multi, gradstream_tiles_plain, row_fold, row_fold_plain,
        spmm_tiles_plain, spmv_tiles_plain, wavepack_gradstream,
        wavepack_spmm, wavepack_spmv)
    from hisparse_tpu_torch.ops.train_stream import grad_stream_operands
    from hisparse_tpu_torch.parallel import (
        Mesh, ShardedBFS, ShardedGCN, ShardedPageRank, ShardedSpmv,
        ShardedSpmv2D, ShardedSpmvMultiHost, ShardedSSSP,
        ShardedStreamDiffSpmv)
    from hisparse_tpu_torch.utils.bench import (device_time_ms,
                                               profile_breakdown)
    gcn, X_gcn, labels = gcn_ctx
    g, pokec = apps["graph"], apps["pokec"]
    m_f, x_f = fixed
    mesh = Mesh([dev] * MESH_SHARDS, ("rows",))
    mesh2 = Mesh(np.array([dev] * 4).reshape(2, 2), ("rows", "cols"))
    mesh_mh = Mesh(np.array([dev] * 4).reshape(2, 2), ("hosts", "chips"))
    cfg_g = SpmvConfig(**GOOGLEPLUS_CFG)
    split_g = GOOGLEPLUS_PACK["split_max"]

    # the modules of the path
    t0 = time.perf_counter()
    sp1 = ShardedSpmv(m_gplus, mesh, cfg_g, split_max=split_g)
    sp2 = ShardedSpmv2D(m_gplus, mesh2, cfg_g, split_max=split_g)
    spm = ShardedSpmvMultiHost(m_gplus, mesh_mh, cfg_g, split_max=split_g)
    t1 = time.perf_counter()
    spf = ShardedSpmv(m_f, mesh, SpmvConfig(**FIXED_CFG),
                      split_max=FIXED_PACK["split_max"])
    cfg_t = dataclasses.replace(SpmvConfig(), semiring="min_plus")
    trop1 = ShardedSpmv(g, mesh, cfg_t, split_max=16)
    trop2 = ShardedSpmv2D(g, mesh2, cfg_t, split_max=16)
    op_t = SpmvOperator(pack(g, cfg_t, split_max=16), dev)
    m70 = uniform_sparse_csr(*T70["shape"], seed=T70["seed"])
    sds = ShardedStreamDiffSpmv(m70, mesh, SpmvConfig(**T70_CFG),
                                SpmvConfig(**T70_CFG_T), split_max=None)
    t2 = time.perf_counter()
    sg = ShardedGCN(m_gplus, mesh, GCN_DIMS, cfg_g, split_max=split_g)
    sg.load_params(gcn.params())
    t3 = time.perf_counter()
    spr = ShardedPageRank(g, mesh)
    sbf = ShardedBFS(g, mesh)
    t4 = time.perf_counter()
    sss = ShardedSSSP(pokec, mesh)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    print(f"mesh build: googleplus 1-D, 2x2 and hosts x chips "
          f"{t1 - t0:.1f} s; fixed row, min_plus 100k, transformer-70 "
          f"{t2 - t1:.1f} s; GCN {t3 - t2:.1f} s; PageRank + BFS "
          f"{t4 - t3:.1f} s; SSSP pokec {t5 - t4:.1f} s; host peak "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} "
          f"GiB, card {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          "allocated", flush=True)
    packs = {"googleplus 1-D": sp1.shards,
             "googleplus 2x2": [w for row in sp2.grid for w in row],
             "fixed row": spf.shards, "min_plus 1-D": trop1.shards,
             "transformer-70 A": sds.d.packsA,
             "transformer-70 A^T": sds.d.packsT,
             "gcn A-hat": sg.agg.packsA, "gcn A-hat^T": sg.agg.packsT,
             "pagerank": spr.st.packs, "bfs": sbf.st.packs,
             "sssp pokec": sss.st.packs}
    tiles = {what: [w.num_tiles for w in ws] for what, ws in packs.items()}
    del packs
    for what, t in tiles.items():
        print(f"mesh tiles {what}: the shards run {t}", flush=True)

    rng = np.random.default_rng(31)
    x_g = torch.from_numpy(rng.random(m_gplus.num_cols).astype(
        np.float32)).to(dev)
    x_t = torch.from_numpy(rng.random(g.num_cols).astype(np.float32)).to(dev)
    x70 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        sds.num_cols).astype(np.float32)).to(dev)
    yt70 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        sds.num_rows).astype(np.float32)).to(dev)
    vals0 = sds.values()
    with torch.no_grad():
        logits_one = gcn(X_gcn)
    torch.cuda.synchronize()

    # the main path, counted
    reset_counts(kernels)
    w0 = time.perf_counter()
    y1 = sp1.unpack_y(sp1(x_g))
    y2 = sp2.unpack_y(sp2(x_g))
    ymh = spm.unpack_y(spm(x_g))
    yf = spf.unpack_y(spf(x_f))
    yt1, yt2 = trop1.unpack_y(trop1(x_t)), trop2.unpack_y(trop2(x_t))
    losses, layouts_equal = [], []
    for step in range(T70_STEPS):
        sds.zero_grad()
        xg = x70.clone().requires_grad_(True)
        y = sds(xg)
        r = y.detach() - yt70
        losses.append(float(0.5 * torch.dot(r, r)))
        y.backward(r)
        if step == 0:
            first = (to_np(y), to_np(r), to_np(xg.grad))
        sds.sgd_step(T70_LR)
        layouts_equal.append(bool(np.array_equal(sds.values(),
                                                 sds.values_T())))
    r = sds(x70).detach() - yt70
    losses.append(float(0.5 * torch.dot(r, r)))
    # ShardedDiffSpmv (the value-vector trainer the stream trainer is
    # built on): its own values scattered into the shards' streams
    sdv = sds.d
    sdv.zero_grad()
    xg = x70.clone().requires_grad_(True)
    y = sdv(xg)
    y.backward(yt70)
    diff_out = (to_np(y.detach()), to_np(xg.grad),
                sdv.unstack_values([v.grad for v in sdv.vals]))
    with torch.no_grad():
        logits = sg(X_gcn)
    gcn_losses = []
    for _ in range(GCN_STEPS):
        sg.zero_grad()
        loss = torch.nn.functional.cross_entropy(sg(X_gcn), labels)
        loss.backward()
        gcn_losses.append(float(loss.detach()))
        with torch.no_grad():
            for p in sg.parameters():
                p -= GCN_LR * p.grad
    with torch.no_grad():
        gcn_losses.append(float(torch.nn.functional.cross_entropy(
            sg(X_gcn), labels)))
    pr = to_np(spr.run(iters=PR_ITERS))
    lv = to_np(sbf.run(source=0))
    dist = to_np(sss.run(source=0))
    torch.cuda.synchronize()
    w1 = time.perf_counter()
    launches = counts(kernels)
    print(f"mesh: main path {w1 - w0:.1f} s; launches {launches}",
          flush=True)
    check(all(launches[k] > 0 for k in ("wavepack_spmv", "wavepack_spmm",
                                        "wavepack_gradstream", "row_fold")),
          f"the mesh path's kernel counts {launches}")

    # googleplus: 1-D against f64, the 2-D and multi-host meshes against
    # the 1-D mesh
    y1n = to_np(y1)
    check(y1n.shape == (m_gplus.num_rows,) and bool(np.isfinite(y1n).all()),
          f"mesh googleplus y {y1n.shape} not finite")
    e_1 = rel_err(y1n, spmv_f64(m_gplus, to_np(x_g)))
    e_2, e_mh = rel_err(to_np(y2), y1n), rel_err(to_np(ymh), y1n)
    ok_nat = exact(y1, sp1.unpack_y(sp1(x_g)))
    print(f"mesh googleplus: 1-D vs spmv_f64 {e_1:.3e}; 2x2 vs 1-D "
          f"{e_2:.3e}; hosts x chips vs 1-D {e_mh:.3e} (gate {TOL_F64}); "
          f"natural y bit-equal run to run {ok_nat}", flush=True)
    check(max(e_1, e_2, e_mh) <= TOL_F64 and ok_nat,
          f"mesh googleplus: {e_1} / {e_2} / {e_mh}, fixed {ok_nat}")
    # Q8.24 and min_plus: bit for bit
    ok_f = bool(np.array_equal(yf.numpy(), spmv_fixed_vec(m_f, x_f,
                                                          m_f.data)))
    y_one = op_t(x_t)
    ok_t = exact(yt1, y_one) and exact(yt2, y_one)
    print(f"mesh fixed row: y == spmv_fixed_vec {ok_f}; min_plus 1-D and "
          f"2x2 == the single-device operator {ok_t}", flush=True)
    check(ok_f and ok_t, f"mesh fixed row {ok_f}, min_plus {ok_t}")
    # training: step 1 against float64 on the values the streams held
    y0, r0, xbar0 = first
    a64 = sds.m.to_scipy().astype(np.float64)
    a64.data = vals0.astype(np.float64)
    e_y = rel_err(y0, a64 @ to_np(x70).astype(np.float64))
    e_xb = rel_err(xbar0, a64.T @ r0.astype(np.float64))
    print(f"mesh transformer-70: loss "
          f"{' -> '.join(f'{v:.6g}' for v in losses)}; step 1 y vs f64 "
          f"{e_y:.3e}, x_bar {e_xb:.3e} (gate {TOL_F64}); "
          f"layouts bit-equal after each step {all(layouts_equal)}",
          flush=True)
    check(all(layouts_equal), "mesh transformer-70: layouts differ")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"mesh transformer-70 loss did not fall: {losses}")
    check(e_y <= TOL_F64 and e_xb <= TOL_F64,
          f"mesh transformer-70 step 1 vs f64: {e_y} / {e_xb}")
    # ShardedDiffSpmv: y and x_bar against float64 on the values its
    # streams carry (the steal-mantissa truncation of the matrix's),
    # dL/dvals bit-equal to the float32 products g[rows] * x[cols]
    y_d, xbar_d, vbar_d = diff_out
    m70c = sdv.m

    def carried_f64(steal: bool):
        a = m70c.to_scipy().astype(np.float64)
        v = m70c.data
        if steal:
            v = (v.view(np.uint32) & np.uint32(0xFFFFFF80)).view(np.float32)
        a.data = v.astype(np.float64)
        return a

    g70, x70n = to_np(yt70), to_np(x70)
    e_dy = rel_err(y_d, carried_f64(sdv.cfg.steal_mantissa)
                   @ x70n.astype(np.float64))
    e_dxb = rel_err(xbar_d, carried_f64(sdv.cfgT.steal_mantissa).T
                    @ g70.astype(np.float64))
    rows70 = np.repeat(np.arange(m70c.num_rows), np.diff(m70c.indptr))
    ok_dv = bool(np.array_equal(vbar_d, g70[rows70] * x70n[m70c.indices]))
    print(f"mesh transformer-70 ShardedDiffSpmv: y vs f64 {e_dy:.3e}, "
          f"x_bar {e_dxb:.3e} (gate {TOL_F64}); dL/dvals == g[rows] * "
          f"x[cols] {ok_dv}", flush=True)
    check(e_dy <= TOL_F64 and e_dxb <= TOL_F64 and ok_dv,
          f"mesh ShardedDiffSpmv: y {e_dy}, x_bar {e_dxb}, dvals {ok_dv}")
    # GCN: the single-device model's logits on the same parameters
    e_g = rel_err(to_np(logits), to_np(logits_one))
    print(f"mesh gcn: logits vs the single-device GCN {e_g:.3e} (gate "
          f"{TOL_MESH_GCN}); loss "
          f"{' -> '.join(f'{v:.6g}' for v in gcn_losses)}", flush=True)
    check(e_g <= TOL_MESH_GCN, f"mesh gcn logits vs GCN {e_g}")
    check(gcn_losses[-1] < gcn_losses[0],
          f"mesh gcn loss did not fall: {gcn_losses}")
    # the apps
    ref_pr = pagerank_reference(g, iters=PR_ITERS)
    e_pr = float(np.abs(pr - ref_pr).max() / np.abs(ref_pr).max())
    ok_bfs = bool(np.array_equal(lv, apps["bfs_levels"]))
    ok_ss = bool(np.array_equal(dist, apps["sssp_dist"]))
    print(f"mesh apps: pagerank vs reference {e_pr} (gate {TOL_MESH_PR}); "
          f"bfs levels == BFS {ok_bfs}; sssp pokec ({sss.iters_run} "
          f"iterations) == SSSP {ok_ss}", flush=True)
    check(e_pr <= TOL_MESH_PR, f"mesh pagerank {e_pr}")
    check(ok_bfs and ok_ss, f"mesh bfs {ok_bfs}, sssp {ok_ss}")

    # one shard of each kernel against its plain version: the SpMV and the
    # gradient stream on transformer-70's first shard (A pack), the SpMM on
    # the GCN's first shard at F = 16, the fold on googleplus's first shard
    op70 = sds.d.opsA[0]
    x0 = x70 if op70.col_order is None else x70[op70.col_order]
    args = op70.stream_args(x0, sds.vA[0].detach())
    e_spmv = rel_err(to_np(wavepack_spmv(*args, op70.cfg)),
                     to_np(spmv_tiles_plain(*args, op70.cfg)))
    g0 = torch.from_numpy(r0[:sds.d.rows_per_shard]).to(dev)
    gargs = grad_stream_operands(op70, sds.vA[0].detach(), sds.maskA[0],
                                 g0, x70)
    ok_grad = exact(wavepack_gradstream(*gargs),
                    gradstream_tiles_plain(*gargs))
    opg = sg.agg.opsA[0]
    H = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (opg.wp.num_cols, 16)).astype(np.float32)).to(dev)
    sargs = (opg.vals, opg.idxT, opg.tile_part, opg.class_map,
             opg.run_start, opg.run_end,
             build_xt_multi(H, opg.cfg, opg.wp.n_parts), opg.cfg)
    e_spmm = rel_err(to_np(wavepack_spmm(*sargs)),
                     to_np(spmm_tiles_plain(*sargs)))
    op1 = sp1.ops[0]
    y_ren = sp1(x_g)[0]
    ok_fold = exact(row_fold(y_ren, op1.fold_idx, op1.fold_ptr,
                             op1.fold_long, "plus_times"),
                    row_fold_plain(y_ren, op1.fold_idx, op1.fold_ptr,
                                   "plus_times"))
    print(f"mesh kernels vs plain, shard 0: spmv (transformer-70 A) "
          f"{e_spmv:.3e}, spmm F=16 (gcn A-hat) {e_spmm:.3e} (gate "
          f"{TOL_PLAIN}); gradient stream bit-equal {ok_grad}; fold "
          f"(googleplus) bit-equal {ok_fold}", flush=True)
    check(e_spmv <= TOL_PLAIN and e_spmm <= TOL_PLAIN and ok_grad
          and ok_fold, f"mesh kernels vs plain: spmv {e_spmv}, spmm "
          f"{e_spmm}, gradient stream {ok_grad}, fold {ok_fold}")

    # the min_plus hub-split folds: SSSP-pokec's first shard on phase 8's
    # distances, and the 100k graph's single-device pack (split 16)
    op_s = sss.st.ops[0]
    d_all = torch.from_numpy(dist).to(dev)
    xr = torch.from_numpy(np.random.default_rng(41).random(
        g.num_cols).astype(np.float32)).to(dev)
    fold_min = {
        "sssp_pokec_shard0": fold_record(
            "sssp-pokec shard 0", op_s,
            op_s(d_all[:sss.st.num_cols], renamed=True), dev),
        "graph100k_split16": fold_record("min_plus 100k split 16", op_t,
                                         op_t(xr, renamed=True), dev)}

    # times: the sharded steps beside the single-device ones on the same
    # matrices (CUDA events, the host's enqueue included)
    op_one = SpmvOperator(pack(m_gplus, cfg_g, split_max=split_g), dev)
    sd_one = StreamDiffSpmv(m70, SpmvConfig(**T70_CFG),
                            SpmvConfig(**T70_CFG_T), device=dev,
                            split_max=None)

    def train_step(module):
        def step():
            module.zero_grad(set_to_none=True)
            xg = x70.detach().requires_grad_(True)
            y = module(xg)
            y.backward(y.detach() - yt70)
        return step

    x_pr = spr.st.zeros()
    x_pr[:g.num_rows] = 1.0 / g.num_rows
    d_pk = torch.from_numpy(dist).to(dev)
    times = {
        "googleplus forward, 4 shards": device_time_ms(
            lambda: sp1.unpack_y(sp1(x_g)), reps=20),
        "googleplus forward, 2x2": device_time_ms(
            lambda: sp2.unpack_y(sp2(x_g)), reps=20),
        "googleplus forward, one operator": device_time_ms(
            lambda: op_one(x_g), reps=20),
        "transformer-70 step, 4 shards": device_time_ms(
            train_step(sds), reps=20),
        "transformer-70 step, one module": device_time_ms(
            train_step(sd_one), reps=20),
        "transformer-70 step, 4 shards (values)": device_time_ms(
            train_step(sdv), reps=20),
        "pagerank-100k step, 4 shards": device_time_ms(
            lambda: spr.step(x_pr), reps=20),
        "sssp-pokec step, 4 shards": device_time_ms(
            lambda: sss.st.step(d_pk), reps=5),
    }
    for what, ms in times.items():
        print(f"time mesh {what:40s} {ms:.4f} ms", flush=True)
    profiles = {
        "googleplus forward, 4 shards": profile_breakdown(
            lambda: sp1.unpack_y(sp1(x_g))),
        "sssp-pokec step, 4 shards": profile_breakdown(
            lambda: sss.st.step(d_pk), steps=3)}
    for what, prof in profiles.items():
        print_profile(f"mesh {what}", prof)
    return launches, {
        "googleplus_rel_err": e_1, "rel_err_2d": e_2,
        "rel_err_multihost": e_mh, "pagerank_rel_err": e_pr,
        "gcn_rel_err": e_g, "transformer70_losses": losses,
        "diffspmv_rel_err": [e_dy, e_dxb],
        "times_ms": times, "tiles": tiles,
        "idle_share": {k: p["idle_share"] for k, p in profiles.items()},
        "fold_min_plus": fold_min}


def phase_tooling(dev, kernels, m, op, rec_single, smi):
    """Phase 11: googleplus through pack_hybrid and HybridSpmv beside the
    single pack ``op`` of phase 4 (whose record is ``rec_single``),
    measure_spmv, device_profile and the parity sweep;
    returns the launches of the hybrid forward and the hybrid's
    record."""
    import torch
    from hisparse_tpu_torch import SpmvConfig
    from hisparse_tpu_torch.formats.wavepack import pack_hybrid
    from hisparse_tpu_torch.ops.golden import spmv_f64
    from hisparse_tpu_torch.ops.spmv import (HybridSpmv, spmv_tiles_plain,
                                             wavepack_spmv)
    from hisparse_tpu_torch.utils.bench import (device_hbm_gbps,
                                               device_time_ms, measure_spmv,
                                               measured_peak_gbps)
    from hisparse_tpu_torch.utils.parity import (parity_sweep, print_sweep,
                                                write_record)
    from hisparse_tpu_torch.utils.tracing import device_profile
    t0 = time.perf_counter()
    wb, wt = pack_hybrid(m, SpmvConfig(**GOOGLEPLUS_CFG), **HYBRID_PACK)
    t_pack = time.perf_counter() - t0
    for tag, wp in (("bulk", wb), ("tail", wt)):
        print(f"hybrid {tag}: tiles {wp.num_tiles}, blocks {wp.n_blocks}, "
              f"parts {wp.n_parts}, nnz {wp.nnz}, fill {wp.fill:.4f}, "
              f"stream {wp.stream_bytes / 1e6:.1f} MB", flush=True)
    hyb = HybridSpmv(wb, wt, device=dev)
    # the tail's leftovers sum their duplicate entries: fewer nnz, the
    # same matrix (y is held against spmv_f64 of m below)
    print(f"hybrid: pack_hybrid {t_pack:.1f} s on the host; nnz {hyb.nnz} "
          f"of the matrix's {m.nnz}; {wb.num_tiles + wt.num_tiles} tiles, "
          f"fill {hyb.fill:.4f}, "
          f"stream {hyb.stream_bytes / 1e6:.1f} MB; single pack (phase 4, "
          f"{rec_single['pack_s']:.1f} s): {op.wp.num_tiles} tiles, fill "
          f"{op.wp.fill:.4f}, stream {op.wp.stream_bytes / 1e6:.1f} MB",
          flush=True)
    x_np = np.random.default_rng(0).random(m.num_cols).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    torch.cuda.synchronize()

    reset_counts(kernels)
    y = hyb(x)
    torch.cuda.synchronize()
    launches = counts(kernels)
    check(launches["wavepack_spmv"] == 2 and launches["row_fold"] == 1,
          f"the hybrid forward's launches {launches}")
    y_np = to_np(y)
    check(y_np.shape == (m.num_rows,) and bool(np.isfinite(y_np).all()),
          f"hybrid y has shape {y_np.shape} or is not finite")
    err = rel_err(y_np, spmv_f64(m, x_np))
    print(f"hybrid: y vs spmv_f64 {err:.3e} (gate {TOL_F64}); launches "
          f"{launches}", flush=True)
    check(err <= TOL_F64, f"hybrid y vs spmv_f64 {err}")

    # each launch against its plain version on the same operands
    runs, max_abs, outs = [], 0.0, []
    for tag, o in (("bulk", hyb.bulk), ("tail", hyb.tail)):
        args = o.stream_args(x if o.col_order is None else x[o.col_order])
        acc_k = wavepack_spmv(*args, o.cfg)
        acc_p = spmv_tiles_plain(*args, o.cfg)
        y_k, y_p = o.renamed_y(acc_k), o.renamed_y(acc_p)
        d = float((y_k - y_p).abs().max())
        e_kp = rel_err(y_k.cpu(), y_p.cpu())
        print(f"hybrid {tag} launch: kernel vs plain max|dy| {d:.3e}, "
              f"relative {e_kp:.3e} (gate {TOL_PLAIN})", flush=True)
        check(e_kp <= TOL_PLAIN, f"hybrid {tag} kernel vs plain {e_kp}")
        max_abs = max(max_abs, d)
        runs.append((tag, o, args))
        outs.append(acc_k)
    b = bound(sum(nbytes(*args) for _, _, args in runs) + nbytes(*outs),
              2.0 * sum(args[0].numel() for _, _, args in runs))
    del outs

    # natural y: the same bits run to run and on the CPU's plain versions
    same_run = exact(y, hyb(x))
    t0 = time.perf_counter()
    y_cpu = HybridSpmv(wb, wt, device="cpu")(torch.from_numpy(x_np))
    t_cpu = time.perf_counter() - t0
    same_cpu = exact(y.cpu(), y_cpu)
    print(f"hybrid: natural y bit-equal run to run {same_run}, to the CPU "
          f"HybridSpmv {same_cpu} ({t_cpu:.1f} s on the CPU)", flush=True)
    check(same_run and same_cpu, "hybrid natural y not fixed")

    # times: each launch alone, then single and hybrid in turns
    ms_launch = {tag: device_time_ms(
        lambda a=args, c=o.cfg: wavepack_spmv(*a, c), reps=50, queued=True)
        for tag, o, args in runs}
    args_s = op.stream_args(x[op.col_order])

    def k_single():
        wavepack_spmv(*args_s, op.cfg)

    def k_hybrid():
        for _, o, args in runs:
            wavepack_spmv(*args, o.cfg)

    turns = {"single": [], "hybrid": []}
    for which in ("single", "hybrid", "hybrid", "single"):
        k, f = ((k_single, op) if which == "single" else (k_hybrid, hyb))
        turns[which].append((
            device_time_ms(k, reps=50, queued=True),
            device_time_ms(lambda f=f: f(x), reps=50)))
    ms_p = device_time_ms(lambda: [spmv_tiles_plain(*args, o.cfg)
                                   for _, o, args in runs], reps=3, warmup=1)
    print(f"time hybrid launches: bulk {ms_launch['bulk']:.4f} ms, tail "
          f"{ms_launch['tail']:.4f} ms; plain (both) {ms_p:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    for which in ("single", "hybrid"):
        (k1, f1), (k2, f2) = turns[which]
        print(f"time googleplus {which:6s} kernel(s) {k1:.4f} / {k2:.4f} ms,"
              f" forward {f1:.4f} / {f2:.4f} ms (turns single, hybrid, "
              f"hybrid, single)", flush=True)
    print(f"time googleplus single pack in phase 4: kernel "
          f"{rec_single['ms']:.4f} ms, forward {rec_single['forward_ms']:.4f}"
          f" ms; cuSPARSE {rec_single['library_ms']:.4f} ms; {smi}",
          flush=True)
    ms_k = float(np.mean([t[0] for t in turns["hybrid"]]))
    ms_fwd = float(np.mean([t[1] for t in turns["hybrid"]]))

    # the reference's benchmark rows, the card's data-sheet and measured
    # HBM rates
    for name, o, nnz, sb, pre, fill in (
            ("googleplus single", op, m.nnz, op.wp.stream_bytes,
             rec_single["pack_s"], op.wp.fill),
            ("googleplus hybrid", hyb, hyb.nnz, hyb.stream_bytes, t_pack,
             hyb.fill)):
        print("measure_spmv " + measure_spmv(name, o, x, nnz, sb, pre,
                                             fill).row(), flush=True)
    hbm, peak = device_hbm_gbps(), measured_peak_gbps()
    print(f"device_hbm_gbps {hbm:.1f} GB/s (data sheet); measured_peak_gbps "
          f"{peak:.1f} GB/s ({peak / hbm:.3f} of it); {smi}", flush=True)
    check(0.3 * hbm <= peak <= 1.05 * hbm, f"measured peak {peak} GB/s")

    # a device trace of three hybrid forwards
    with device_profile(OUT_DIR, device="cuda") as prof:
        for _ in range(3):
            hyb(x)
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and "wavepack_kernel" in e.get("name", "")]
    print(f"device_profile: {prof.trace_path.rsplit('/', 3)[-3:]}, "
          f"{len(events)} events, {len(kern)} wavepack kernel events "
          f"({kern[0]['name'][:80] if kern else None})", flush=True)
    check(len(kern) >= 1, "the trace holds no wavepack kernel event")

    fams = parity_sweep("cuda")
    print_sweep(fams)
    path = write_record(fams, OUT_DIR)
    bad = [k for k, r in fams.items() if not r["ok"]]
    print(f"parity: {len(fams) - len(bad)} of {len(fams)} families ok -> "
          f"{path.rsplit('/', 3)[-3:]}", flush=True)
    check(not bad, f"parity families not ok: {bad}")
    return launches, {
        "max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p, **b,
        "library_ms": rec_single["library_ms"], "forward_ms": ms_fwd,
        "launch_ms": ms_launch, "turns_ms": turns, "pack_s": t_pack,
        "tiles": [wb.num_tiles, wt.num_tiles], "fill": hyb.fill,
        "stream_mb": hyb.stream_bytes / 1e6, "rel_err_f64": err,
        "measured_peak_gbps": peak, "hbm_gbps": hbm,
        "trace_wavepack_events": len(kern),
        "parity": {k: r["ok"] for k, r in fams.items()}}


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    from hisparse_tpu_torch.formats import native
    from hisparse_tpu_torch.ops import _kernels

    # -- phase 2: builds --------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {len(_kernels.KERNELS)} kernels from "
          f"{len(_kernels.LIBRARIES)} sources in parallel "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print_registers(_kernels.register_counts())
    print(f"build: ptxas -v of the {len(_kernels.LIBRARIES)} sources "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_kernel_info(_kernels)
    t0 = time.perf_counter()
    check(native.available(), "the native packer did not build (g++)")
    print(f"build: native packer {time.perf_counter() - t0:.1f} s",
          flush=True)
    from hisparse_tpu_torch.models.perf_model import RATES_PATH, card_rates
    rated = card_rates()["device"]
    print(f"rates: {RATES_PATH.rsplit('/', 3)[-3:]} measured on {rated!r}; "
          f"this card {'matches' if rated == smi.strip() else 'differs'}",
          flush=True)

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    print(f"chip_smoke: phases 1-2 in {t_phase - t_start:.1f} s", flush=True)

    def done(n: int) -> None:
        nonlocal t_phase
        t = time.perf_counter()
        print(f"chip_smoke: phase {n} in {t - t_phase:.1f} s", flush=True)
        t_phase = t

    fams = phase_families(dev)
    done(3)
    m, op_gplus, rec_spmv, rec_fold, l_serve = phase_serving(dev, _kernels)
    done(4)
    worst_g, worst_s = phase_kernel_families(dev)
    semiring = phase_semiring_families(dev)
    fold_edge = semiring.pop("fold_edge_comparisons")
    done(5)
    rec_grad, rec_train_spmv, l_train = phase_training(dev, _kernels)
    done(6)
    rec_spmm, rec_fold_gcn, l_gcn, gcn_ctx = phase_gcn(dev, _kernels, m)
    done(7)
    rec_apps, rec_masked, rec_spmm_paged, l_apps, apps_ctx = phase_apps(
        dev, _kernels)
    done(8)
    rec_bcsr, rec_rows, l_dispatch, fixed_ctx = phase_dispatch(
        dev, _kernels, m)
    fold_fixed = rec_rows.pop("fold_fixed_row")
    done(9)
    l_mesh, rec_mesh = phase_mesh(dev, _kernels, m, gcn_ctx, apps_ctx,
                                  fixed_ctx)
    done(10)
    del gcn_ctx, apps_ctx
    fold_min = rec_mesh.pop("fold_min_plus")
    print("mesh: " + json.dumps(rec_mesh), flush=True)
    l_hybrid, rec_hybrid = phase_tooling(dev, _kernels, m, op_gplus,
                                         rec_spmv, smi)
    done(11)
    del m, op_gplus

    paths = {"serving": l_serve, "training": l_train, "gcn": l_gcn,
             "apps": l_apps, "dispatch": l_dispatch, "mesh": l_mesh,
             "hybrid": l_hybrid}
    src = "hisparse_tpu_torch/csrc/"
    ref = "hisparse_tpu/ops/spmv.py"
    # the SpMV kernel's max_abs_err covers googleplus, the training packs
    # and the apps' packs (bit-equal there)
    rec_spmv = dict(rec_spmv, max_abs_err=max(
        rec_spmv["max_abs_err"], rec_train_spmv["max_abs_err"],
        rec_apps["max_abs_err"], rec_hybrid["max_abs_err"]),
        training=rec_train_spmv, apps=rec_apps, dispatch=rec_rows,
        hybrid=rec_hybrid)
    # each kernel's source and every TPU kernel body it replaces
    rows = [
        ("wavepack_spmv", "wavepack_spmv.cu", f"{ref}:258, {ref}:295",
         rec_spmv, {**fams, **semiring}),
        ("wavepack_gradstream", "wavepack_gradstream.cu", f"{ref}:516",
         rec_grad, {"worst_family_rel_err": worst_g}),
        ("wavepack_spmm", "wavepack_spmv.cu", f"{ref}:325, {ref}:363",
         rec_spmm, {"worst_family_rel_err": worst_s, **rec_spmm_paged}),
        ("wavepack_spmv_masked", "wavepack_spmv.cu", f"{ref}:497, {ref}:509",
         rec_masked, {}),
        ("bcsr", "bcsr.cu", "hisparse_tpu/ops/bcsr.py:56", rec_bcsr, {}),
        ("row_fold", "row_fold.cu",
         "hisparse_tpu/formats/wavepack.py:133 (Wavepack.unpack_y, host "
         "numpy; no pallas_call)", rec_fold,
         {"gcn_f16": rec_fold_gcn, "fixed_row": fold_fixed,
          "min_plus_hub": fold_min,
          "edge_plan_comparisons": fold_edge,
          "natural_order_comparisons": rec_fold.pop(
              "natural_order_comparisons")
          + semiring["natural_order_comparisons"]
          + rec_rows["fixed_row_natural_order_comparisons"]}),
    ]
    record = {"kernels": []}
    for name, source, replaces, rec, extra in rows:
        entry = {"name": name, "route": "cuda", "source": f"{src}{source}",
                 "replaces": replaces}
        entry.update(
            launches=sum(p[name] for p in paths.values()),
            launches_by_path={k: p[name] for k, p in paths.items()},
            **rec, **extra)
        record["kernels"].append(entry)
    print(f"chip_smoke: phases 1-11 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
