"""Smoke run of hisparse_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  1. require a CUDA device; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them;
  2. build the four CUDA kernels (nvcc, sm_90a, one process for each of
     the two sources, in parallel; SpMV, SpMM and the masked SpMV share
     one kernel body) and the native packer (g++) from the sources in this
     checkout; print the build seconds and each kernel's registers per
     thread (``ptxas -v``, the sources compiled once more);
  3. on the fp32 parity families of the JAX package's chip sweep (plus one
     two-block pack), hold the SpMV kernel against its plain PyTorch
     version on the same CUDA operands (max|dy|/max|y| <= 1e-6) and both
     against the f64 golden (<= 1e-4);
  4. serving at full size: the googleplus stand-in of the suite,
     powerlaw_csr(108000, 108000, 127, 1.2, seed=11), packed natively at
     its tuned design point, through SpmvOperator(wp, device="cuda") to
     natural-order y; y within 1e-4 of spmv_f64, and the SpMV kernel's
     launch counter, zeroed just before, above 0.  Then the kernel (with
     and without its host enqueue), its plain version, the whole forward
     and a cuSPARSE CSR SpMV (torch.sparse_csr_tensor @ x, a yardstick
     only) are timed on CUDA events and printed with GOPS = 2*nnz/t and
     GB/s = bytes/t;
  5. on the same families, the gradient-stream kernel against its plain
     version (max|d| <= 1e-6 of max|out|) and the SpMM kernel against its
     plain version at F = 1, 5 and 16 (max|d|/max|Y| <= 1e-6); on the
     min_plus and max_times families the SpMV kernel bit for bit against
     its plain version and within 1e-4 of the float64 oracle, SpMM at F = 5
     bit for bit; on every fp32 family in each semiring its config allows,
     the masked kernel bit for bit against its plain version with 40
     active columns, and masked == full; a NaN in x in the same slots
     through the SpMV, masked and SpMM kernels and their plain versions;
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
     timed, and the forward and the step profiled;
  7. GCN at full size: two layers, hidden width 16 (Kipf & Welling), on
     the googleplus stand-in, 64 input features and 8 classes from numpy
     seeds, the adjacency packed at phase 4's design point: logits within
     1e-4 of a float64 scipy oracle, the cross-entropy falling over 3 SGD
     steps, the SpMM counter above 0; the SpMM kernel against its plain
     version on A-hat and A-hat^T at F = 8 and 16 (1e-6); one training
     step is timed and profiled, the SpMM kernel timed at F = 16.

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
     Dijkstra seconds and the masked call's host time printed.

The kernels' times keep the host's enqueue out
(``device_time_ms(queued=True)``); the forwards, steps and plain versions
are timed with it, as their callers wait for it.  A profile
(``utils/bench.profile_breakdown``) prints a call's device time by op and
its device idle share.  The line before the last is a JSON object with
the four kernels' records: launches by path, each time beside its bound
(the larger of the bytes it must move over 3.35 TB/s and its fp32
operations over 67 TFLOP/s) and, where one PyTorch call computes the same
function, that call's time (``library_ms``: cuSPARSE SpMV and SpMM; no
PyTorch call computes the gradient stream or a masked SpMV); the last is
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
TOL_PLAIN = 1e-6
TOL_F64 = 1e-4
# the card's peaks for bound_ms (NVIDIA data sheet, H100 SXM at 700 W): HBM3
# bytes and fp32 operations outside the tensor cores, a second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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
            "wavepack_spmv_masked": kernels.masked_launches}


def reset_counts(kernels) -> None:
    kernels.launches = 0
    kernels.gradstream_launches = 0
    kernels.spmm_launches = 0
    kernels.masked_launches = 0


def print_registers(counts: dict) -> None:
    """Registers per thread of each kernel, grouped by kind: the SpMV body
    by features, semiring and masked flag (over the six kinds of pack),
    the gradient stream alone."""
    import re
    names = {"0": "plus_times", "1": "min_plus", "2": "max_times"}
    groups: dict = {}
    for sym, regs in counts.items():
        m = re.search(r"wavepack_kernelI[is]Lb\dELb\dELi(\d+)ELi(\d)ELb(\d)E",
                      sym)
        key = (f"wavepack_kernel kF={m[1]} {names[m[2]]}"
               + (" masked" if m[3] == "1" else "")) if m else (
            "wavepack_gradstream_kernel" if "gradstream" in sym else sym)
        groups.setdefault(key, []).append(regs)
    for key in sorted(groups):
        r = groups[key]
        print(f"registers {key}: {min(r)}-{max(r)} ({len(r)} "
              "instantiations)", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, n_ops: float) -> dict:
    """``bound_ms``, the least time the card could take for work that
    moves ``n_bytes`` and does ``n_ops`` fp32 operations, and ``bound_by``,
    which of the two sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


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


def phase_families(dev) -> float:
    """Phase 3: the SpMV kernel vs its plain version on the families."""
    import torch
    from hisparse_tpu_torch import SpmvOperator
    from hisparse_tpu_torch.ops.golden import spmv_f64
    from hisparse_tpu_torch.ops.spmv import spmv_tiles_plain, wavepack_spmv
    from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES,
                                               MULTIBLOCK_FAMILY, family_case)
    worst = 0.0
    for fam in FP32_FAMILIES + (MULTIBLOCK_FAMILY,):
        m, wp, x = family_case(fam)
        op = SpmvOperator(wp, device=dev)
        args = op.stream_args(torch.from_numpy(x).to(dev))
        y_k = op.renamed_y(wavepack_spmv(*args, op.cfg))
        y_p = op.renamed_y(spmv_tiles_plain(*args, op.cfg))
        ref = spmv_f64(m, x)
        e_kp = rel_err(y_k.cpu(), y_p.cpu())
        e_k = rel_err(op.unpack_device(y_k).cpu(), ref)
        e_p = rel_err(op.unpack_device(y_p).cpu(), ref)
        worst = max(worst, e_kp)
        print(f"family {fam[0]:18s} tiles {wp.num_tiles:3d} blocks "
              f"{wp.n_blocks} parts {wp.n_parts}: kernel-vs-plain {e_kp:.3e}"
              f"  kernel-vs-f64 {e_k:.3e}  plain-vs-f64 {e_p:.3e}",
              flush=True)
        check(e_kp <= TOL_PLAIN, f"{fam[0]}: kernel vs plain {e_kp}")
        check(e_k <= TOL_F64 and e_p <= TOL_F64,
              f"{fam[0]}: vs spmv_f64 {e_k} / {e_p}")
    return worst


def phase_serving(dev, kernels):
    """Phase 4: googleplus through SpmvOperator; returns (matrix, record,
    launches of the path)."""
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
              "forward_ms": ms_fwd}
    return m, record, launches


def phase_kernel_families(dev) -> tuple:
    """Phase 5: the gradient-stream and SpMM kernels vs their plain
    versions on the families; returns the worst relative errors."""
    import torch
    from hisparse_tpu_torch import SpmvOperator
    from hisparse_tpu_torch.ops.spmv import (
        build_xt, build_xt_multi, gradstream_tiles_plain, spmm_tiles_plain,
        wavepack_gradstream, wavepack_spmm)
    from hisparse_tpu_torch.utils.bench import (FP32_FAMILIES,
                                               MULTIBLOCK_FAMILY, family_case)
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
            e_s.append(rel_err(to_np(wavepack_spmm(*sargs)),
                               to_np(spmm_tiles_plain(*sargs))))
        worst_s = max(worst_s, *e_s)
        print(f"family {fam[0]:18s} gradstream kernel-vs-plain {e_g:.3e}  "
              "spmm kernel-vs-plain F=1/5/16 "
              + " / ".join(f"{e:.3e}" for e in e_s), flush=True)
        check(e_g <= TOL_PLAIN, f"{fam[0]}: gradstream kernel vs plain {e_g}")
        check(max(e_s) <= TOL_PLAIN, f"{fam[0]}: spmm kernel vs plain {e_s}")
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
        FP32_FAMILIES, MULTIBLOCK_FAMILY, SEMIRING_FAMILIES, family_case,
        family_inputs, semiring_f64, sparse_x)
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
        ok_m = exact(wavepack_spmm(*sargs), spmm_tiles_plain(*sargs))
        print(f"family {fam[0]:22s} spmv kernel==plain {ok_k}, vs f64 "
              f"{e:.3e} (same infinite rows {same_inf}); spmm F=5 "
              f"kernel==plain {ok_m}", flush=True)
        check(ok_k and ok_m, f"{fam[0]}: kernel vs plain not bit-equal")
        check(e <= TOL_F64 and same_inf, f"{fam[0]}: vs f64 {e}")
        worst_f64 = max(worst_f64, e)
        n_exact += 2
    # the masked kernel on every fp32 family, in each semiring
    for fam in FP32_FAMILIES + (MULTIBLOCK_FAMILY,):
        args, split, _ = family_inputs(fam)
        m = powerlaw_csr(*args)
        line = []
        for sr in ("plus_times", "min_plus", "max_times"):
            if sr == "min_plus" and fam[1].get("steal_mantissa"):
                continue
            wp = pack(m, SpmvConfig(**dict(fam[1], semiring=sr)),
                      split_max=split)
            op = SpmvOperator(wp, device=dev)
            x, act = sparse_x(m.num_cols, MASKED_ACTIVE, sr, seed=3)
            x_dev = torch.from_numpy(x).to(dev)
            margs = masked_operands(op, x_dev, act)
            ok = exact(wavepack_spmv_masked(*margs),
                       spmv_masked_tiles_plain(*margs))
            # plus_times in renamed order: index_add_ adds a split row's
            # partials in no fixed order on the card
            ren = sr == "plus_times"
            same = exact(op.masked(x_dev, act, renamed=ren),
                         op(x_dev, renamed=ren))
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
               exact(wavepack_spmm(*sargs), spmm_tiles_plain(*sargs)))
        n_nan = int(torch.isnan(acc).sum())
        print(f"NaN case {sr}: {n_nan} NaN slots; spmv, masked, masked "
              f"plain, spmm equal {oks}", flush=True)
        check(all(oks) and n_nan > 0, f"NaN case {sr}: {oks}, {n_nan}")
        n_exact += 4
    return {"worst_semiring_rel_err_f64": worst_f64,
            "bit_equal_comparisons": n_exact}


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
          f"({b_g['bound_by']})", flush=True)
    print(f"time transformer-70 forward {ms_fwd:.4f} ms "
          f"({2 * nnz / ms_fwd / 1e6:.2f} GOPS); gradient step {ms_step:.4f}"
          f" ms kernels, {ms_plain:.4f} ms plain versions", flush=True)
    prof_fwd = profile_breakdown(fwd)
    print_profile("transformer-70 forward", prof_fwd)
    prof_step = profile_breakdown(step)
    print_profile("transformer-70 gradient step", prof_step)
    return {"max_abs_err": max_abs, "ms": ms_gk, "plain_ms": ms_gp, **b_g,
            "library_ms": None, "forward_ms": ms_fwd, "step_ms": ms_step,
            "plain_step_ms": ms_plain,
            "step_idle_share": prof_step["idle_share"]}, {
        "max_abs_err": spmv_abs, "rel_err_y": e_ky,
        "rel_err_x_bar": e_kxb}, launches


def phase_gcn(dev, kernels, m):
    """Phase 7: the GCN on googleplus; returns the SpMM record and the
    launches of the path."""
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
            acc_k = wavepack_spmm(*sargs)
            acc_p = spmm_tiles_plain(*sargs)
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
    return {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p, **b_s,
            "library_ms": ms_cs, "gcn_step_ms": prof["ms"],
            "step_idle_share": prof["idle_share"]}, launches


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
    from hisparse_tpu_torch.ops.spmv import (spmv_masked_tiles_plain,
                                             spmv_tiles_plain, wavepack_spmv,
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
                "pagerank_rel_err": e_pr, "sssp_rel_err": e_ss}
    rec_masked = {"max_abs_err": max(c["masked_max_abs"] for c in cmps),
                  "ms": ms_mk, "plain_ms": ms_mp,
                  **b_m, "library_ms": None,
                  "tiles": int(margs[2].numel()),
                  "of_tiles": ss.wp.num_tiles,
                  "sssp_masked_step_ms": ms_ssm,
                  "sssp_tiles_per_iteration": sssp_tiles,
                  "bfs_tiles_per_iteration": bfs_tiles}
    return rec_spmv, rec_masked, launches


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
    print(f"build: ptxas -v of both sources {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    check(native.available(), "the native packer did not build (g++)")
    print(f"build: native packer {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    worst = phase_families(dev)                          # phase 3
    m, rec_spmv, l_serve = phase_serving(dev, _kernels)  # phase 4
    worst_g, worst_s = phase_kernel_families(dev)        # phase 5
    semiring = phase_semiring_families(dev)
    rec_grad, rec_train_spmv, l_train = phase_training(
        dev, _kernels)                                   # phase 6
    rec_spmm, l_gcn = phase_gcn(dev, _kernels, m)        # phase 7
    del m
    rec_apps, rec_masked, l_apps = phase_apps(dev, _kernels)  # phase 8

    paths = {"serving": l_serve, "training": l_train, "gcn": l_gcn,
             "apps": l_apps}
    src = "hisparse_tpu_torch/csrc/"
    ref = "hisparse_tpu/ops/spmv.py"
    # the SpMV kernel's max_abs_err covers googleplus, the training packs
    # and the apps' packs (bit-equal there)
    rec_spmv = dict(rec_spmv, max_abs_err=max(
        rec_spmv["max_abs_err"], rec_train_spmv["max_abs_err"],
        rec_apps["max_abs_err"]), training=rec_train_spmv, apps=rec_apps)
    # each kernel's source and every TPU kernel body it replaces
    rows = [
        ("wavepack_spmv", "wavepack_spmv.cu", f"{ref}:258, {ref}:295",
         rec_spmv, {"worst_family_rel_err": worst, **semiring}),
        ("wavepack_gradstream", "wavepack_gradstream.cu", f"{ref}:516",
         rec_grad, {"worst_family_rel_err": worst_g}),
        ("wavepack_spmm", "wavepack_spmv.cu", f"{ref}:325, {ref}:363",
         rec_spmm, {"worst_family_rel_err": worst_s}),
        ("wavepack_spmv_masked", "wavepack_spmv.cu", f"{ref}:497, {ref}:509",
         rec_masked, {}),
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
    print(f"chip_smoke: phases 1-8 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
