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
     the operator's y against the golden (f64 within 1e-4, bf16 within
     8e-3; Q8.24 equal to golden.spmv_fixed_vec);
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
     unpack, a yardstick only), and its longest hub row timed alone;
  5. on the same families, the gradient-stream kernel against its plain
     version (max|d| <= 1e-6 of max|out|) and the SpMM kernel against its
     plain version at F = 1, 5 and 16 (max|d|/max|Y| <= 1e-6; the bf16
     stream at F = 1, 3, 5, 8 and 16 bit for bit); on the
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
     and to Wavepack.unpack_y of the same call's renamed y;
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
     step is timed and profiled, the SpMM kernel timed at F = 16, and the
     fold of A-hat's F = 16 renamed rows beside index_add_.

  8. the graph apps at the suite's sizes (bench.py:736-800): PageRank
     (20 iterations) and BFS (from vertex 0, dense and masked) on
     powerlaw_csr(100000, 100000, 10, alpha=1.3, seed=2), SSSP (from
     vertex 0 to the fixpoint, dense and masked) on the pokec stand-in
     rmat_csr(1632000, 1632000, 19, seed=6), every run counted: PageRank
     within 1e-4 of pagerank_reference (max|r - ref| / max|ref|), BFS levels
     equal to scipy's, SSSP within 1e-4 (relative, at least 1) of Dijkstra
     with the same vertices unreachable, masked equal to dense, the SpMV
     and masked counters above 0.  Then the SpMV kernel against its plain
     version on the PageRank pack, a combine level, the BFS pack and the
     pokec pack, and the masked kernel at a BFS frontier and a mid-run SSSP
     frontier, bit for bit (the plain versions walk the 680M-slot pokec
     stream in chunks); the two kernels timed on the pokec pack beside
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
     one copy to the host); each dense pick's forward beside its bound and
     the wavepack forward of the same matrix.

The kernels' times keep the host's enqueue out
(``device_time_ms(queued=True)``); the forwards, steps and plain versions
are timed with it, as their callers wait for it.  A profile
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
launches (registers, shared memory, CTAs per SM); the last is
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time

import numpy as np

GOOGLEPLUS = dict(shape=(108000, 108000, 127.0, 1.2), seed=11)
GOOGLEPLUS_CFG = dict(sublanes=512, bank_blocks=8, stripes=512,
                      block_major=True, classes_per_group=2,
                      steal_mantissa=True, idx16=True, two_choice=False)
GOOGLEPLUS_PACK = dict(split_max=64, col_order="degree", bm_win=1, bm_adv=1)
# bench.py:819-824
T70 = dict(shape=(512, 33288, int(33288 * 0.30)), seed=70)
T70_CFG = dict(sublanes=512, bank_blocks=1, stripes=4, steal_mantissa=True,
               idx16=True, two_choice=False)
T70_CFG_T = dict(T70_CFG, stripes=512)
T70_STEPS, T70_LR = 5, 5e-5
GCN_DIMS, GCN_STEPS, GCN_LR = [64, 16, 8], 3, 0.5
# the app rows of the suite (bench.py:736-800): PageRank and BFS on the
# 100k power-law graph, SSSP on the pokec-shape R-MAT stand-in
APPS_100K = dict(shape=(100000, 100000, 10), alpha=1.3, seed=2)
POKEC = dict(shape=(1632000, 1632000, 19), seed=6)
PR_ITERS = 20
MASKED_ACTIVE = 40            # active columns of the phase-5 masked cases
# the dispatch rows (bench.py:533-537, :677-679, :897-921): the pruned-NN
# suite, the fixed-point row at its tuned point (bench_tuned.json) and the
# block-structured SpMM row with 64 right-hand sides
TRANSFORMER_PCTS = (50, 60, 70, 80, 90, 95)
FIXED_ROW = dict(shape=(60000, 60000, 16), seed=1)
FIXED_CFG = dict(sublanes=512, bank_blocks=4, stripes=512, dtype="fixed",
                 block_major=True, classes_per_group=2, two_choice=True)
FIXED_PACK = dict(split_max=16, col_order="degree", bm_win=1, bm_adv=1)
BCSR16K = dict(shape=(16384, 16384), block_rows=24, seed=7)
BCSR_RHS = 64
TOL_PLAIN = 1e-6
TOL_F64 = 1e-4
TOL_BF16 = 8e-3               # one bf16 rounding a term (test_formats.py:433)
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
                                  "row_fold_kernel")
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
            ("wavepack_spmm", 16, 1)):
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
    cuSPARSE yardsticks."""
    import torch
    a = m.to_scipy()
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


def fold_bound(y, idx, ptr, long_rows, out) -> dict:
    """The fold's bound: y, the plan and the output each moved once, one
    operation a partial and feature."""
    F = y.shape[0] if y.dim() == 2 else 1
    return bound(nbytes(y, idx, ptr, long_rows, out), float(F * idx.numel()))


def fold_record(what, op, y_ren, dev) -> dict:
    """The fold kernel on ``op``'s renamed y (``(n,)`` or ``(F, n)``): bit
    for bit against its plain version and ``Wavepack.unpack_y``, timed
    beside its bound, its plain version and ``index_add_`` over perm (the
    earlier unpack, in no fixed order), and its longest row's range timed
    alone (one warp walking it)."""
    import torch
    from hisparse_tpu_torch.ops.spmv import (FOLD_THREAD_MAX, row_fold,
                                             row_fold_plain)
    from hisparse_tpu_torch.utils.bench import device_time_ms
    alg = op.cfg.semiring
    plan = (op.fold_idx, op.fold_ptr, op.fold_long)
    out_k = row_fold(y_ren, *plan, alg)
    out_p = row_fold_plain(y_ren, op.fold_idx, op.fold_ptr, alg)
    ys = y_ren.reshape(-1, y_ren.shape[-1]).cpu().numpy()
    ref = torch.from_numpy(np.stack([op.wp.unpack_y(v) for v in ys])).to(
        dev).reshape(out_k.shape)
    ok = exact(out_k, out_p) and exact(out_k, ref)
    check(ok, f"{what}: fold kernel vs plain / unpack_y not bit-equal")
    n = op.wp.num_rows
    ms_k = device_time_ms(lambda: row_fold(y_ren, *plan, alg), reps=50,
                          queued=True)
    ms_p = device_time_ms(lambda: row_fold_plain(y_ren, op.fold_idx,
                                                 op.fold_ptr, alg),
                          reps=3, warmup=1)
    lead = y_ren.shape[:-1]

    def index_add():
        return torch.zeros(lead + (n + 1,), device=dev).index_add_(
            -1, op.perm, y_ren)

    ms_ia = device_time_ms(index_add, reps=50, queued=True)
    lengths = (op.fold_ptr[1:] - op.fold_ptr[:-1]).cpu().numpy()
    r = int(lengths.argmax())
    L = int(lengths[r])
    beg = int(op.fold_ptr[r])
    one = (op.fold_idx[beg:beg + L].contiguous(),
           torch.tensor([0, L], dtype=torch.int32, device=dev),
           torch.tensor([0] if L > FOLD_THREAD_MAX else [],
                        dtype=torch.int32, device=dev))
    ms_long = device_time_ms(lambda: row_fold(y_ren, *one, alg), reps=50,
                             queued=True)
    b = fold_bound(y_ren, *plan, out_k)
    print(f"fold {what}: {tuple(y_ren.shape)} renamed -> {n} rows, "
          f"{op.fold_idx.numel()} partials, {op.fold_long.numel()} hub rows "
          f"of more than {FOLD_THREAD_MAX}; kernel == plain == unpack_y {ok};"
          f" kernel {ms_k:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}), plain {ms_p:.4f} ms, index_add_ {ms_ia:.4f} "
          f"ms; longest row {L} partials alone {ms_long:.4f} ms", flush=True)
    return {"max_abs_err": max_abs_diff(out_k, out_p), "ms": ms_k,
            "plain_ms": ms_p, **b, "library_ms": ms_ia,
            "longest_row_partials": L, "longest_row_ms": ms_long,
            "partials": int(op.fold_idx.numel()),
            "hub_rows": int(op.fold_long.numel())}


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
    operator's y against the golden."""
    from hisparse_tpu_torch import SpmvOperator
    from hisparse_tpu_torch.ops.golden import spmv_f64, spmv_fixed_vec
    from hisparse_tpu_torch.ops.spmv import spmv_tiles_plain, wavepack_spmv
    from hisparse_tpu_torch.utils.bench import (MULTIBLOCK_FAMILY,
                                               PLUS_TIMES_FAMILIES,
                                               family_case)
    worst, n_exact = 0.0, 0
    for fam in PLUS_TIMES_FAMILIES + (MULTIBLOCK_FAMILY,):
        m, wp, x = family_case(fam)
        op = SpmvOperator(wp, device=dev)
        dtype = op.cfg.dtype
        args = op.stream_args(family_x(op, x, dev))
        acc_k = wavepack_spmv(*args, op.cfg)
        acc_p = spmv_tiles_plain(*args, op.cfg)
        head = (f"family {fam[0]:18s} tiles {wp.num_tiles:3d} blocks "
                f"{wp.n_blocks} parts {wp.n_parts}: ")
        if dtype != "fp32":
            ok = exact(acc_k, acc_p)
            if dtype == "fixed":
                y = op(x).numpy()
                good = bool(np.array_equal(y, spmv_fixed_vec(m, x, m.data)))
                what = f"y == spmv_fixed_vec {good}"
            else:
                e = rel_err(to_np(op(x)), spmv_f64(m, x))
                good = e <= TOL_BF16
                what = f"y vs f64 {e:.3e} (gate {TOL_BF16})"
            print(head + f"kernel==plain {ok}; {what}", flush=True)
            check(ok and good, f"{fam[0]}: kernel==plain {ok}, {what}")
            n_exact += 1
            continue
        y_k, y_p = op.renamed_y(acc_k), op.renamed_y(acc_p)
        ref = spmv_f64(m, x)
        e_kp = rel_err(y_k.cpu(), y_p.cpu())
        e_k = rel_err(op.unpack_device(y_k).cpu(), ref)
        e_p = rel_err(op.unpack_device(y_p).cpu(), ref)
        worst = max(worst, e_kp)
        print(head + f"kernel-vs-plain {e_kp:.3e}  kernel-vs-f64 {e_k:.3e}  "
              f"plain-vs-f64 {e_p:.3e}", flush=True)
        check(e_kp <= TOL_PLAIN, f"{fam[0]}: kernel vs plain {e_kp}")
        check(e_k <= TOL_F64 and e_p <= TOL_F64,
              f"{fam[0]}: vs spmv_f64 {e_k} / {e_p}")
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
              "forward_ms": ms_fwd,
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
    return m, record, rec_fold, launches


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
        e_s = []
        for F in (1, 5, 16):
            X = torch.from_numpy(rng.standard_normal(
                (wp.num_cols, F)).astype(np.float32)).to(dev)
            sargs = (op.vals, op.idxT, op.tile_part, op.class_map,
                     op.run_start, op.run_end,
                     build_xt_multi(X, cfg, wp.n_parts), cfg)
            e_s.append(rel_err(to_np(wavepack_spmm(*sargs, F=F)),
                               to_np(spmm_tiles_plain(*sargs, F=F))))
        worst_s = max(worst_s, *e_s)
        print(f"family {fam[0]:18s} gradstream kernel-vs-plain {e_g:.3e}  "
              "spmm kernel-vs-plain F=1/5/16 "
              + " / ".join(f"{e:.3e}" for e in e_s), flush=True)
        check(e_g <= TOL_PLAIN, f"{fam[0]}: gradstream kernel vs plain {e_g}")
        check(max(e_s) <= TOL_PLAIN, f"{fam[0]}: spmm kernel vs plain {e_s}")
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
    version and within TOL_F64 of the float64 oracle, SpMM at F = 5 bit for
    bit; on every fp32 family in each semiring its config allows, the
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
        SEMIRING_FAMILIES, family_case, family_inputs, semiring_f64,
        sparse_x)
    worst_f64, n_exact = 0.0, 0
    for fam in SEMIRING_FAMILIES:
        m, wp, x = family_case(fam)
        sr = wp.config.semiring
        op = SpmvOperator(wp, device=dev)
        x_dev = torch.from_numpy(x).to(dev)
        args = op.stream_args(x_dev)
        ok_k = exact(wavepack_spmv(*args, op.cfg),
                     spmv_tiles_plain(*args, op.cfg))
        y = to_np(op(x_dev))
        ref = semiring_f64(m, x, sr)
        fin = np.isfinite(ref)
        e = rel_err(y[fin], ref[fin])
        same_inf = bool((np.isfinite(y) == fin).all())
        X = torch.from_numpy(np.random.default_rng(5).random(
            (wp.num_cols, 5)).astype(np.float32)).to(dev)
        sargs = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
                 op.run_end, build_xt_multi(X, op.cfg, wp.n_parts), op.cfg)
        ok_m = exact(wavepack_spmm(*sargs, F=5),
                     spmm_tiles_plain(*sargs, F=5))
        print(f"family {fam[0]:22s} spmv kernel==plain {ok_k}, vs f64 "
              f"{e:.3e} (same infinite rows {same_inf}); spmm F=5 "
              f"kernel==plain {ok_m}", flush=True)
        check(ok_k and ok_m, f"{fam[0]}: kernel vs plain not bit-equal")
        check(e <= TOL_F64 and same_inf, f"{fam[0]}: vs f64 {e}")
        worst_f64 = max(worst_f64, e)
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
            "natural_order_comparisons": n_nat}


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
    record at F = 16 and the launches of the path."""
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
    # the fold of A-hat's 16 renamed feature rows, as the aggregation's
    # natural-order output takes it
    rec_fold = fold_record("gcn A-hat F=16", gcn.agg.op,
                           gcn.agg.op.matmul(H16, renamed=True), dev)
    return {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p, **b_s,
            "library_ms": ms_cs, "gcn_step_ms": prof["ms"],
            "step_idle_share": prof["idle_share"],
            "instantiation": instantiation(kernels, "wavepack_spmm",
                                           gcn.agg.op, Fp=16)}, \
        rec_fold, launches


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


def phase_apps(dev, kernels):
    """Phase 8: PageRank and BFS on the 100k power-law graph and SSSP on
    the pokec stand-in through the port's apps; returns the records of the
    SpMV and masked kernels and the launches of the path."""
    import torch
    from hisparse_tpu_torch import (BFS, SSSP, PageRank,
                                    normalize_by_outdegree,
                                    pagerank_reference, powerlaw_csr,
                                    rmat_csr, sssp_reference)
    from hisparse_tpu_torch.models.apps import y_to_rank
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
          f"{t1 - t0:.1f} s; PageRank pack + combine {t2 - t1:.1f} s, BFS "
          f"{t3 - t2:.1f} s", flush=True)
    print(f"pokec: {m.num_rows}x{m.num_cols} nnz {m.nnz}; generate "
          f"{t4 - t3:.1f} s, SSSP transpose + pack + combine + upload "
          f"{t5 - t4:.1f} s", flush=True)
    for tag, app in (("pagerank", pr), ("bfs", bf), ("sssp", ss)):
        wp = app.wp
        print(f"{tag} pack: tiles {wp.num_tiles}, blocks {wp.n_blocks}, "
              f"parts {wp.n_parts}, fill {wp.fill:.4f}, stream "
              f"{wp.stream_bytes / 1e6:.1f} MB; combine levels "
              f"{len(app.combine)} ({', '.join(str(w.num_tiles) for w, _ in app.combine)} tiles)",
              flush=True)

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
          and launches["wavepack_spmv_masked"] > 0,
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
    wp_c, op_c = pr.combine[0]
    x_c = y_to_rank(pr.wp, pr.op(x_pr[:pr.n], renamed=True))
    cmps.append(compare_at(f"pagerank combine level 1 ({wp_c.num_tiles} "
                           "tiles)", op_c, x_c, None))
    k_bfs = max(1, int(lv_d.max()) // 2)
    front_nat = torch.from_numpy((lv_d == k_bfs).astype(np.float32)).to(dev)
    f_rank = rank_vector(bf, front_nat, 0.0)
    cmps.append(compare_at(f"bfs pack at the level-{k_bfs} frontier "
                           f"({int(front_nat.sum())} vertices)", bf.op,
                           f_rank[:bf.n], bf.inv[lv_d == k_bfs]))
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
    return rec_spmv, rec_masked, rec_spmm_paged, launches


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
    kernel's record, the dispatch rows' record and the launches of the
    path."""
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
                "fixed_row_natural_order_comparisons": n_nat}
    return rec_bcsr, rec_rows, launches


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
    fams = phase_families(dev)                           # phase 3
    m, rec_spmv, rec_fold, l_serve = phase_serving(
        dev, _kernels)                                   # phase 4
    worst_g, worst_s = phase_kernel_families(dev)        # phase 5
    semiring = phase_semiring_families(dev)
    rec_grad, rec_train_spmv, l_train = phase_training(
        dev, _kernels)                                   # phase 6
    rec_spmm, rec_fold_gcn, l_gcn = phase_gcn(
        dev, _kernels, m)                                # phase 7
    rec_apps, rec_masked, rec_spmm_paged, l_apps = phase_apps(
        dev, _kernels)                                   # phase 8
    rec_bcsr, rec_rows, l_dispatch = phase_dispatch(
        dev, _kernels, m)                                # phase 9
    del m

    paths = {"serving": l_serve, "training": l_train, "gcn": l_gcn,
             "apps": l_apps, "dispatch": l_dispatch}
    src = "hisparse_tpu_torch/csrc/"
    ref = "hisparse_tpu/ops/spmv.py"
    # the SpMV kernel's max_abs_err covers googleplus, the training packs
    # and the apps' packs (bit-equal there)
    rec_spmv = dict(rec_spmv, max_abs_err=max(
        rec_spmv["max_abs_err"], rec_train_spmv["max_abs_err"],
        rec_apps["max_abs_err"]), training=rec_train_spmv, apps=rec_apps,
        dispatch=rec_rows)
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
         {"gcn_f16": rec_fold_gcn,
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
    print(f"chip_smoke: phases 1-9 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
