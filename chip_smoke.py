"""Smoke run of hisparse_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  1. require a CUDA device; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them;
  2. build the wavepack SpMV kernel (nvcc, sm_90a) and the native packer
     (g++) from the sources in this checkout; print the build seconds;
  3. on the fp32 parity families of the JAX package's chip sweep (plus one
     two-block pack), hold the kernel against its plain PyTorch version on
     the same CUDA operands (max|dy|/max|y| <= 1e-6) and both against the
     f64 golden (<= 1e-4);
  4. the main path at full size: the googleplus stand-in of the suite,
     powerlaw_csr(108000, 108000, 127, 1.2, seed=11), packed natively at
     its tuned design point, through SpmvOperator(wp, device="cuda") to
     natural-order y; y within 1e-4 of spmv_f64, and the kernel's launch
     counter, zeroed just before, above 0.  Then the kernel, its plain
     version, the whole forward and a cuSPARSE CSR SpMV
     (torch.sparse_csr_tensor @ x, a yardstick only) are timed on CUDA
     events and printed with GOPS = 2*nnz/t and GB/s = bytes/t.

The line before the last is a JSON object with the kernel's record; the
last is ``{"ok": true, "device": {...}}``.
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
TOL_PLAIN = 1e-6
TOL_F64 = 1e-4


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    from hisparse_tpu_torch import SpmvConfig, SpmvOperator, pack, powerlaw_csr
    from hisparse_tpu_torch.formats import native
    from hisparse_tpu_torch.ops import _kernels
    from hisparse_tpu_torch.ops.golden import spmv_f64
    from hisparse_tpu_torch.ops.spmv import spmv_tiles_plain, wavepack_spmv
    from hisparse_tpu_torch.utils.bench import (
        FP32_FAMILIES, MULTIBLOCK_FAMILY, device_time_ms, family_case, gbps,
        gops)

    # -- phase 2: builds --------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: wavepack_spmv kernel {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    check(native.available(), "the native packer did not build (g++)")
    print(f"build: native packer {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")

    # -- phase 3: kernel vs plain version on the parity families ---------
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

    # -- phase 4: the main path at full size -----------------------------
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

    _kernels.launches = 0
    y = op(x)
    torch.cuda.synchronize()
    launches = _kernels.launches
    check(launches > 0, "the main path launched no wavepack_spmv kernel")

    y_np = y.cpu().numpy()
    check(y_np.shape == (m.num_rows,) and y_np.dtype == np.float32,
          f"y has shape {y_np.shape} {y_np.dtype}")
    check(bool(np.isfinite(y_np).all()), "y is not finite")
    ref = spmv_f64(m, x_np)
    err = rel_err(y_np, ref)
    print(f"googleplus: y vs spmv_f64 {err:.3e} (gate {TOL_F64}); "
          f"kernel launches {launches}", flush=True)
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
    del acc_k, acc_p, y_k, y_p

    ms_k = device_time_ms(lambda: wavepack_spmv(*args, cfg), reps=50)
    ms_p = device_time_ms(lambda: spmv_tiles_plain(*args, cfg), reps=5,
                          warmup=1)
    ms_fwd = device_time_ms(lambda: op(x), reps=50)
    a_sp = m.to_scipy()
    a_sp.sum_duplicates()
    a_cs = torch.sparse_csr_tensor(
        torch.from_numpy(a_sp.indptr.astype(np.int32)),
        torch.from_numpy(a_sp.indices.astype(np.int32)),
        torch.from_numpy(a_sp.data.astype(np.float32)),
        size=a_sp.shape, check_invariants=False).to(dev)
    e_cs = rel_err(torch.mv(a_cs, x).cpu(), ref)
    ms_cs = device_time_ms(lambda: torch.mv(a_cs, x), reps=50)
    # values + column indices + row pointers, each 4 B
    csr_bytes = a_sp.nnz * 8 + (a_sp.shape[0] + 1) * 4
    nnz, sb = m.nnz, wp.stream_bytes
    for what, ms, nbytes in (
            ("kernel wavepack_spmv", ms_k, sb),
            ("plain spmv_tiles_plain", ms_p, sb),
            ("forward SpmvOperator(x)", ms_fwd, sb),
            ("cuSPARSE csr @ x", ms_cs, csr_bytes)):
        print(f"time {what:24s} {ms:.4f} ms  {gops(nnz, ms):.2f} GOPS  "
              f"{gbps(nbytes, ms):.1f} GB/s of {nbytes / 1e6:.1f} MB",
              flush=True)
    print(f"cuSPARSE y vs spmv_f64 {e_cs:.3e}", flush=True)

    record = {"kernels": [{
        "name": "wavepack_spmv",
        "route": "cuda",
        "source": "hisparse_tpu_torch/csrc/wavepack_spmv.cu",
        "replaces": "hisparse_tpu/ops/spmv.py:258",
        "also_replaces": "hisparse_tpu/ops/spmv.py:295",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_p,
        "worst_family_rel_err": worst,
        "forward_ms": ms_fwd,
        "cusparse_ms": ms_cs,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
