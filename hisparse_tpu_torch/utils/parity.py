"""The port's chip parity sweep: the counterpart of the JAX package's
``scripts/tpu_check.py`` (``parity_sweep`` and ``round5_parity``, which
wrote ``parity_tpu.json``), over the same 23 families on the same seeded
operands.

    python -m hisparse_tpu_torch.utils.parity --out DIR

runs every family on the CUDA device and writes ``DIR/parity_cuda.json``:
the card's name and power limit as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives them, the torch and CUDA
versions, one record a family and ``ok``.  It exits non-zero if a family
fails.

Each family runs the kernels its path launches and, on the same CUDA
operands, their plain PyTorch versions, and holds the two to PERF.md's
kernel-parity gates: within 1e-6 of max(max|plain|, 1) for fp32
plus_times SpMV and SpMM outputs, bit for bit for min_plus, max_times,
masked, bf16, Q8.24 and the gradient stream.  The path's natural-order
result is held against a float64 golden: within 1e-4 of max(max|golden|,
1), or within the family's own ``parity_tpu.json`` gate where that gate
was against a dense reference (the training, SpMM and GCN families); a
Q8.24 result equal to ``golden.spmv_fixed_vec``; a bf16 result also
within 8e-3 of the golden of the unrounded values.  ``chip_smoke.py``
holds its SpMV families through ``spmv_family`` too.  A record is
``{err_plain, err_f64, tol: {plain, f64}, ok, secs}``.

The sweep holds CUDA kernels, so on the CPU, where every wrapper runs its
plain version, it refuses to run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import powerlaw_csr
from ..formats.wavepack import bf16_bits_to_f32, f32_to_bf16_bits, pack
from ..ops.golden import spmv_f64, spmv_fixed_vec
from ..ops.spmv import (SpmvOperator, build_xt_multi, fixed_bits,
                        gradstream_tiles_plain, spmm_tiles_plain,
                        spmv_masked_tiles_plain, spmv_tiles_plain,
                        wavepack_gradstream, wavepack_spmm, wavepack_spmv,
                        wavepack_spmv_masked)
from .bench import PARITY_FAMILIES, family_case, semiring_f64

TOL_PLAIN = 1e-6
TOL_F64 = 1e-4
TOL_BF16 = 8e-3     # one bf16 rounding a term (tests/test_formats.py:433)

# (name, SpmvConfig fields beyond sublanes=128 and stripes=128): the
# masked families of scripts/tpu_check.py:121-129
MASKED_FAMILIES = (
    ("masked-chain", dict(bank_blocks=2, two_choice=False)),
    ("masked-bm-steal", dict(bank_blocks=2, block_major=True,
                             classes_per_group=2, two_choice=False,
                             steal_mantissa=True)),
    ("masked-paged", dict(bank_blocks=1, two_choice=False)),
)
# (name, steal_mantissa, the f64 gate): scripts/tpu_check.py:148-150
DIFF_FAMILIES = (("diff-fp32", False, 5e-5), ("diff-steal", True, 5e-4))
# (name, SpmvConfig fields beyond sublanes=128, bank_blocks=2 and
# stripes=128): scripts/tpu_check.py:184-188
STREAM_FAMILIES = (
    ("stream-chain", {}),
    ("stream-bm-steal", dict(block_major=True, classes_per_group=2,
                             steal_mantissa=True, two_choice=False)),
)
# (name, SpmvConfig fields beyond sublanes=128 and stripes=128, columns
# beyond one partition, features, the f64 gate): scripts/tpu_check.py:
# 222-230
SPMM_FAMILIES = (
    ("spmm-chain", dict(bank_blocks=2, two_choice=False), 0, 5, 1e-5),
    ("spmm-bm-steal", dict(bank_blocks=2, block_major=True,
                           classes_per_group=2, two_choice=False,
                           steal_mantissa=True), 0, 8, 5e-4),
    ("spmm-paged", dict(bank_blocks=1, two_choice=False), 2 * 128 * 128, 4,
     1e-5),
)
GCN_DIMS = [16, 8, 4]

# the 23 families of parity_tpu.json, in its order
PARITY_FAMILIES_23 = (tuple(f[0] for f in PARITY_FAMILIES)
                      + tuple(f[0] for f in MASKED_FAMILIES)
                      + tuple(f[0] for f in DIFF_FAMILIES)
                      + tuple(f[0] for f in STREAM_FAMILIES)
                      + tuple(f[0] for f in SPMM_FAMILIES) + ("gnn-gcn",))


def rel(a, b) -> float:
    """max|a - b| / max(max|b|, 1) over b's finite slots; inf unless the
    other slots hold the same infinities and NaNs in both."""
    a = torch.as_tensor(a).detach().double().cpu()
    b = torch.as_tensor(b).detach().double().cpu()
    fin = torch.isfinite(b)
    an, bn = a[~fin], b[~fin]
    if not (torch.equal(torch.isfinite(a), fin)
            and bool(((an == bn) | (an.isnan() & bn.isnan())).all())):
        return float("inf")
    if not fin.any():
        return 0.0
    scale = max(float(b[fin].abs().max()), 1.0)
    return float((a[fin] - b[fin]).abs().max()) / scale


def bit_equal(a, b) -> bool:
    """Bit for bit, signed zeros and infinities included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _record(err_plain, exact, err_f64, tol_plain, tol_f64) -> dict:
    """A family's record; ``exact`` (or None where the gate is
    ``tol_plain``) says whether the kernel and plain results agree bit for
    bit."""
    ok_plain = exact if exact is not None else err_plain <= tol_plain
    return {"err_plain": err_plain, "err_f64": err_f64,
            "tol": {"plain": tol_plain, "f64": tol_f64},
            "ok": bool(ok_plain and err_f64 <= tol_f64)}


def _packed(op, x):
    return x if op.col_order is None else x[op.col_order]


def _spmv_pair(op, x, vals=None):
    """Natural-order y of ``op`` on natural-order ``x`` (and stream
    ``vals``) through the SpMV kernel and through its plain version."""
    args = op.stream_args(_packed(op, x), vals)
    return tuple(op.unpack_device(op.renamed_y(f(*args, op.cfg)))
                 for f in (wavepack_spmv, spmv_tiles_plain))


def _spmm_pair(op, X):
    """The SpMM kernel's and its plain version's (n_blocks*F*S, 128)
    accumulators for natural-order features X (F <= 16)."""
    xt = build_xt_multi(_packed(op, X), op.cfg, op.wp.n_parts)
    args = (op.vals, op.idxT, op.tile_part, op.class_map, op.run_start,
            op.run_end, xt)
    return tuple(f(*args, op.cfg, F=X.shape[1])
                 for f in (wavepack_spmm, spmm_tiles_plain))


def spmv_family(fam, dev) -> dict:
    """One SpMV family of ``utils/bench`` (the 12 of ``PARITY_FAMILIES``,
    ``MULTIBLOCK_FAMILY``, ``SEMIRING_FAMILIES``): the kernel against its
    plain version, and natural-order y through each of them against the
    float64 golden (a min_plus / max_times y with the same infinities).
    A bf16 family's golden is of the values the stream holds; its y is
    also held within ``TOL_BF16`` of the golden of the unrounded values
    (``err_f64_unrounded``)."""
    m, wp, x = family_case(fam)
    op = SpmvOperator(wp, device=dev)
    cfg = op.cfg
    xd = (fixed_bits(x) if cfg.dtype == "fixed"
          else torch.from_numpy(x)).to(dev)
    args = op.stream_args(_packed(op, xd))
    acc_k = wavepack_spmv(*args, cfg)
    acc_p = spmv_tiles_plain(*args, cfg)
    fp32_sum = cfg.dtype == "fp32" and cfg.semiring == "plus_times"
    exact = None if fp32_sum else bit_equal(acc_k, acc_p)
    if cfg.dtype == "fixed":
        y = op(x).numpy().astype(np.int64)
        err_f64 = float(np.abs(y - spmv_fixed_vec(m, x, m.data).astype(
            np.int64)).max())
        return _record(0.0 if exact else float(
            (acc_k.long() - acc_p.long()).abs().max()), exact, err_f64,
            0.0, 0.0)
    ys = [op.unpack_device(op.renamed_y(acc)) for acc in (acc_k, acc_p)]
    ys.append(op(xd))
    if cfg.dtype == "bf16":
        err_unrounded = max(rel(y, spmv_f64(m, x)) for y in ys)
        m = dataclasses.replace(m, data=bf16_bits_to_f32(
            f32_to_bf16_bits(m.data)))
    ref = semiring_f64(m, x, cfg.semiring)
    rec = _record(rel(acc_k, acc_p), exact, max(rel(y, ref) for y in ys),
                  TOL_PLAIN if fp32_sum else 0.0, TOL_F64)
    if cfg.dtype == "bf16":
        rec["err_f64_unrounded"] = err_unrounded
        rec["tol"]["f64_unrounded"] = TOL_BF16
        rec["ok"] = rec["ok"] and err_unrounded <= TOL_BF16
    return rec


def masked_family(i, dev) -> dict:
    """The masked kernel, 40 active columns (scripts/tpu_check.py:130-
    142): against its plain version and, in natural order, against the
    full SpMV, both bit for bit."""
    _, kw = MASKED_FAMILIES[i]
    m = powerlaw_csr(3000, 40000, 6, seed=4 + i)
    wp = pack(m, SpmvConfig(sublanes=128, stripes=128, **kw), split_max=16,
              col_order="degree")
    op = SpmvOperator(wp, device=dev)
    rng = np.random.default_rng(20 + i)
    act = rng.choice(m.num_cols, 40, replace=False)
    x = np.zeros(m.num_cols, np.float32)
    x[act] = rng.random(40).astype(np.float32) + 0.5
    xd = torch.from_numpy(x).to(dev)
    margs = op.masked_args(_packed(op, xd),
                           op.active_tiles(op._col_rank[act]))
    acc_k = wavepack_spmv_masked(*margs, op.cfg)
    acc_p = spmv_masked_tiles_plain(*margs, op.cfg)
    y_masked, y_full = op.masked(xd, act), op(xd)
    exact = bit_equal(acc_k, acc_p) and bit_equal(y_masked, y_full)
    return _record(max(rel(acc_k, acc_p), rel(y_masked, y_full)), exact,
                   rel(y_masked, spmv_f64(m, x)), 0.0, TOL_F64)


def _f64_grads(m, x, g):
    """float64 y = A x, A^T g and g[rows] * x[cols] of a CSR matrix."""
    a = m.to_scipy().astype(np.float64)
    x64, g64 = x.astype(np.float64), g.astype(np.float64)
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
    return a @ x64, a.T @ g64, g64[rows] * x64[m.indices]


def diff_family(i, dev) -> dict:
    """DiffSpmv forward, dL/dx and dL/dvals (scripts/tpu_check.py:
    146-178): y and x_bar through the SpMV kernel against its plain
    version at 1e-6; dL/dvals, which takes no kernel, bit for bit against
    g[rows] * x[cols]."""
    from ..ops.autodiff import DiffSpmv, emit_vals
    _, steal, tol = DIFF_FAMILIES[i]
    d = DiffSpmv(powerlaw_csr(1500, 2000, 6, seed=9 + steal),
                 SpmvConfig(steal_mantissa=steal), device=dev)
    rng = np.random.default_rng(31 + steal)
    x = rng.standard_normal(d.num_cols).astype(np.float32)
    g = rng.standard_normal(d.num_rows).astype(np.float32)
    xd, gd = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
    xg = xd.clone().requires_grad_(True)
    y = d(xg)
    y.backward(gd)
    v = d.vals.detach()
    y_k, y_p = _spmv_pair(d.op, xd, emit_vals(v, d.mapA, d.srcA, d.stealA,
                                              d.op.vals.shape))
    xb_k, xb_p = _spmv_pair(d.opT, gd, emit_vals(v, d.mapT, d.srcT,
                                                 d.stealT, d.opT.vals.shape))
    gv = d.vals.grad
    exact_gv = bit_equal(gv, gd[d.rows] * xd[d.cols])
    err_plain = max(rel(y_k, y_p), rel(xb_k, xb_p))
    y64, xb64, gv64 = _f64_grads(d.m, x, g)
    err_f64 = max(rel(y, y64), rel(xg.grad, xb64), rel(gv, gv64))
    rec = _record(err_plain, None, err_f64, TOL_PLAIN, tol)
    rec["ok"] = rec["ok"] and exact_gv
    return rec


def stream_family(i, dev) -> dict:
    """StreamDiffSpmv forward, dL/dx and both gradient streams
    (scripts/tpu_check.py:180-218): y and x_bar through the SpMV kernel
    against its plain version at 1e-6, the gradient-stream kernel bit for
    bit against its plain version on both packs."""
    from ..ops.train_stream import StreamDiffSpmv, grad_stream_operands
    _, kw = STREAM_FAMILIES[i]
    steal = kw.get("steal_mantissa", False)
    sd = StreamDiffSpmv(powerlaw_csr(1500, 2000, 6, seed=12 + i),
                        SpmvConfig(sublanes=128, bank_blocks=2, stripes=128,
                                   **kw), device=dev)
    rng = np.random.default_rng(41 + i)
    x = rng.standard_normal(sd.num_cols).astype(np.float32)
    g = rng.standard_normal(sd.num_rows).astype(np.float32)
    xd, gd = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
    xg = xd.clone().requires_grad_(True)
    y = sd(xg)
    y.backward(gd)
    op, opT = sd.d.op, sd.d.opT
    vA, vT = sd.vA.detach(), sd.vT.detach()
    y_k, y_p = _spmv_pair(op, xd, vA)
    xb_k, xb_p = _spmv_pair(opT, gd, vT)
    gargs = (grad_stream_operands(op, vA, sd.maskA, gd, xd),
            grad_stream_operands(opT, vT, sd.maskT, xd, gd))
    exact_g = all(bit_equal(wavepack_gradstream(*a),
                            gradstream_tiles_plain(*a)) for a in gargs)
    err_plain = max(rel(y_k, y_p), rel(xb_k, xb_p))
    y64, xb64, gv64 = _f64_grads(sd.m, x, g)
    gvT = sd.vT.grad.reshape(-1)[sd.d.mapT]
    err_f64 = max(rel(y, y64), rel(xg.grad, xb64),
                  rel(sd.grads_csr(sd.vA.grad), gv64), rel(gvT, gv64))
    rec = _record(err_plain, None, err_f64, TOL_PLAIN,
                  5e-4 if steal else 5e-5)
    rec["ok"] = rec["ok"] and exact_g
    return rec


def spmm_family(i, dev) -> dict:
    """SpMM Y = A X (scripts/tpu_check.py:220-244): the kernel against its
    plain version at 1e-6, Y against float64."""
    _, kw, extra, F, tol = SPMM_FAMILIES[i]
    cfg = SpmvConfig(sublanes=128, stripes=128, **kw)
    m = powerlaw_csr(2500, cfg.vb_cols + extra, 6, seed=61 + i)
    op = SpmvOperator(pack(m, cfg, split_max=16), device=dev)
    X = np.random.default_rng(71 + i).standard_normal(
        (m.num_cols, F)).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)
    acc_k, acc_p = _spmm_pair(op, Xd)
    ref = m.to_scipy().astype(np.float64) @ X.astype(np.float64)
    return _record(rel(acc_k, acc_p), None, rel(op.matmul(Xd), ref),
                   TOL_PLAIN, tol)


def gcn_family(dev) -> dict:
    """A [16, 8, 4] GCN, forward and weight gradients (scripts/
    tpu_check.py:246-285), against an all-dense float64 GCN on the same
    normalised adjacency; the SpMM kernel against its plain version at
    1e-6 on the Â pack at each layer's input and on the Â^T pack at the
    output cotangent (F = 4) and its projection (F = 8)."""
    from ..models.gnn import GCN
    m = powerlaw_csr(1500, 1500, 6, seed=83)
    gcn = GCN(m, GCN_DIMS, device=dev, seed=2)
    rng = np.random.default_rng(91)
    X = rng.standard_normal((1500, 16)).astype(np.float32)
    G = rng.standard_normal((1500, 4)).astype(np.float32)
    Xd, Gd = torch.from_numpy(X).to(dev), torch.from_numpy(G).to(dev)
    out = gcn(Xd)
    (out * Gd).sum().backward()
    errs = []
    with torch.no_grad():
        h = Xd
        for i, (w, b) in enumerate(zip(gcn.w, gcn.b)):
            acc_k, acc_p = _spmm_pair(gcn.agg.op, h @ w)
            errs.append(rel(acc_k, acc_p))
            h = gcn.agg.op.matmul(h @ w) + b
            if i < len(gcn.w) - 1:
                h = torch.relu(h)
        for cot in (Gd, Gd @ gcn.w[1].T):
            acc_k, acc_p = _spmm_pair(gcn.agg.opT, cot)
            errs.append(rel(acc_k, acc_p))
    a = torch.from_numpy(gcn.agg.m.to_scipy().toarray()).double()
    ps = [(w.detach().cpu().double().requires_grad_(True),
           b.detach().cpu().double().requires_grad_(True))
          for w, b in zip(gcn.w, gcn.b)]
    h = torch.from_numpy(X).double()
    for i, (w, b) in enumerate(ps):
        h = a @ (h @ w) + b
        if i < len(ps) - 1:
            h = torch.relu(h)
    (h * torch.from_numpy(G).double()).sum().backward()
    grads = [rel(p.grad, q.grad) for p, q in zip(
        [t for wb in zip(gcn.w, gcn.b) for t in wb],
        [t for wb in ps for t in wb])]
    err_f64 = max([rel(out.detach(), h.detach())] + grads)
    return _record(max(errs), None, err_f64, TOL_PLAIN, 1e-4)


def parity_sweep(device="cuda") -> dict:
    """Every family of ``PARITY_FAMILIES_23`` on ``device``, a CUDA
    device: ``{family: {err_plain, err_f64, tol, ok, secs}}``.  Raises
    ``ValueError`` for a CPU device (no kernel to hold there) and
    ``RuntimeError`` without a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("parity_sweep holds the CUDA kernels against their "
                         "plain versions; on the CPU every wrapper runs its "
                         "plain version, so there is no kernel to hold")
    if not torch.cuda.is_available():
        raise RuntimeError("parity_sweep needs a CUDA device")
    runs = ([(f[0], lambda f=f: spmv_family(f, dev)) for f in PARITY_FAMILIES]
            + [(f[0], lambda i=i: masked_family(i, dev))
               for i, f in enumerate(MASKED_FAMILIES)]
            + [(f[0], lambda i=i: diff_family(i, dev))
               for i, f in enumerate(DIFF_FAMILIES)]
            + [(f[0], lambda i=i: stream_family(i, dev))
               for i, f in enumerate(STREAM_FAMILIES)]
            + [(f[0], lambda i=i: spmm_family(i, dev))
               for i, f in enumerate(SPMM_FAMILIES)]
            + [("gnn-gcn", lambda: gcn_family(dev))])
    out = {}
    for name, run in runs:
        t0 = time.perf_counter()
        rec = run()
        torch.cuda.synchronize()
        rec["secs"] = time.perf_counter() - t0
        out[name] = rec
    return out


def print_sweep(fams: dict) -> None:
    for name, r in fams.items():
        extra = ("" if "err_f64_unrounded" not in r else
                 f"  unrounded {r['err_f64_unrounded']:.3e} (gate "
                 f"{r['tol']['f64_unrounded']:g})")
        secs = f"  {r['secs']:.2f} s" if "secs" in r else ""
        print(f"{'OK ' if r['ok'] else 'BAD'} {name:22s} plain "
              f"{r['err_plain']:.3e} (gate {r['tol']['plain']:g})  f64 "
              f"{r['err_f64']:.3e} (gate {r['tol']['f64']:g}){extra}{secs}",
              flush=True)


def write_record(fams: dict, out_dir: str) -> str:
    """Write ``out_dir/parity_cuda.json`` for a sweep's families: the
    card's ``nvidia-smi`` name and power limit, torch and CUDA versions,
    the families and ``ok``.  Returns the path."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    rec = {"platform": "gpu", "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "families": fams,
           "ok": all(r["ok"] for r in fams.values())}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "parity_cuda.json")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's parity sweep over the 23 families of "
                    "parity_tpu.json on the CUDA device; writes "
                    "OUT/parity_cuda.json.")
    ap.add_argument("--out", required=True,
                    help="directory for parity_cuda.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parity: needs a CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    fams = parity_sweep("cuda")
    print_sweep(fams)
    ok = all(r["ok"] for r in fams.values())
    path = write_record(fams, args.out)
    print(f"{'PARITY PASS' if ok else 'PARITY FAIL'} -> {path}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
