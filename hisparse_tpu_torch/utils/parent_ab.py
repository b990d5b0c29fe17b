"""Time the gradient-stream, BCSR and fold kernels beside an earlier
checkout's, on one GPU, in one process.

    python -m hisparse_tpu_torch.utils.parent_ab --parent ROOT \
        [--only row_fold] [--e2e] [--sweep]

ROOT is an earlier whole checkout, for instance the parent commit
unpacked with ``git archive`` into the gitignored ``scratch/``.  Its
kernels are built with nvcc from its ``hisparse_tpu_torch/csrc/`` (its
``wavepack_gradstream.cu``, ``bcsr.cu``, ``row_fold.cu`` and
``route.cuh``) beside this checkout's (``ops/_kernels.load``); their C
entry points are ``wavepack_gradstream_f32`` (the current signature),
``bcsr_spmm_launch(blocks, bf16, brow_ptr, bcol, x, out, nbr, kp,
stream)`` and ``row_fold_launch(y, idx, ptr, long_rows, out, n_rows,
n_long, n_ren, F, thread_max, alg, stream)`` (y (F, n_ren) only).  The
parent's fold takes the fold plan its own checkout's ``fold_plan``
makes, in a fresh process there.  Each kernel is timed in turns, parent,
change, change, parent, with CUDA events and the host enqueue held out
(``utils/bench.device_time_ms(queued=True)``), on ``chip_smoke.py``'s
design points (``utils/bench``): the gradient stream on the
transformer-70 training packs A and A^T (``StreamDiffSpmv`` at bench.py's
configs, through ``grad_stream_operands``), BCSR on bcsr-spmm-16k in bf16
with 64 right-hand sides, the fold on googleplus's renamed y (F = 1), on
the GCN's A-hat at F = 16 (the change in both its layouts, the parent on
(F, n)) and on a min_plus hub-split pack (the 100k app graph at split
16).  The outputs are checked: the gradient streams and the folds bit for
bit against each other, BCSR within 1e-4 of max|Y|.  ``--only`` picks the
kernels to time.  ``--e2e`` also times the GCN on googleplus in fresh
processes, one a sample, each checkout's own package: its natural-order
matmul on A-hat at F = 16 (SpMM, stripe fold and fold) and one training
step (with its host enqueue, as the caller waits for it); one warm-up
process a side (dropped), then ``PAIRS`` pairs whose first side
alternates, judged by the mean paired difference (parent - change)
against twice its standard error.  ``--sweep`` also times variants of
this checkout's gradient stream (``SWEEP``: a ring of 3 items, 512-thread
CTAs, and with its x gathers or its stores taken out, which are not
correct products) between the change's two turns.  Prints the card's name
and power limit, one line a (shape, kernel, turn) or pair and, last, one
JSON object of the medians and the pairs' verdicts; needs nvcc and a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import (block_structured_csr, powerlaw_csr, save_npz,
                           uniform_sparse_csr)
from ..formats.wavepack import pack
from ..models.gnn import gcn_normalize
from ..ops import _kernels
from ..ops.bcsr import BcsrOperator, bcsr_spmm
from ..ops.spmv import (FOLD_THREAD_MAX, SpmvOperator, _n_ops, row_fold,
                        wavepack_gradstream)
from ..ops.train_stream import StreamDiffSpmv, grad_stream_operands
from .bench import (APPS_100K, BCSR16K, BCSR_RHS, GCN_DIMS, GOOGLEPLUS,
                    GOOGLEPLUS_CFG, GOOGLEPLUS_PACK, T70, T70_CFG,
                    device_time_ms)

GCN_F = GCN_DIMS[1]           # the hidden width A-hat aggregates
APPS_SPLIT = 16               # chip_smoke.py's min_plus 100k pack (phase 10)
PAIRS = 10
KERNELS = ("gradstream", "bcsr", "row_fold")
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_BCSR_ARGS = [_P, _I, _P, _P, _P, _P, _I, _I, _P]
PARENT_FOLD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# run in a fresh process inside a checkout (its own hisparse_tpu_torch):
# its fold plan of the pack's perm in the npz argv[1], saved to argv[2]
PLAN_CODE = """
import sys
import numpy as np
from hisparse_tpu_torch.ops.spmv import fold_plan
z = np.load(sys.argv[1])
np.savez(sys.argv[2], *fold_plan(z["perm"], int(z["num_rows"])))
"""
# run in a fresh process inside a checkout: the GCN on the matrix in the
# npz argv[1], its natural-order matmul at F = dims[1] and one training
# step timed; prints one JSON line
E2E_CODE = """
import json, sys
import numpy as np, torch
from hisparse_tpu_torch import GCN, SpmvConfig, load_npz
from hisparse_tpu_torch.utils.bench import device_time_ms
path, dims, cfg, pk = sys.argv[1], *map(json.loads, sys.argv[2:5])
m = load_npz(path)
dev = torch.device("cuda")
gcn = GCN(m, dims, SpmvConfig(**cfg), device=dev, seed=0, **pk)
n = m.num_rows
X = torch.from_numpy(np.random.default_rng(5).standard_normal(
    (n, dims[0])).astype(np.float32)).to(dev)
H = torch.from_numpy(np.random.default_rng(23).standard_normal(
    (n, dims[1])).astype(np.float32)).to(dev)
labels = torch.from_numpy(np.random.default_rng(6).integers(
    0, dims[-1], n)).to(dev)
def step():
    gcn.zero_grad(set_to_none=True)
    torch.nn.functional.cross_entropy(gcn(X), labels).backward()
print(json.dumps({"matmul_natural_ms": device_time_ms(
    lambda: gcn.agg.op.matmul(H), reps=50), "gcn_step_ms": device_time_ms(
    step, reps=20)}))
"""
# variants of csrc/wavepack_gradstream.cu: (name, [(old, new), ...], whether
# the output stays the product)
SWEEP = (
    ("3-stages", [("constexpr int kStages = 2;",
                   "constexpr int kStages = 3;")], True),
    ("512-threads", [("constexpr int kGThreads = 256;",
                      "constexpr int kGThreads = 512;")], True),
    ("no-gather", [("xv[i] = __ldg(xt + off);",
                    "xv[i] = __int_as_float(off | 0x3f800000);")], False),
    ("no-store", [("      __stcs(reinterpret_cast<float4*>(",
                   "      if (o.x == -1.5e-38f) __stcs("
                   "reinterpret_cast<float4*>(")], False),
)


def build_parent(parent: str, out_dir: str) -> dict:
    """The parent checkout's three libraries, compiled in parallel."""
    nvcc = _kernels._nvcc()
    csrc = os.path.join(parent, "hisparse_tpu_torch", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in ("wavepack_gradstream", "bcsr", "row_fold"):
        so = os.path.join(out_dir, f"{name}.so")
        procs.append((name, so, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, f"-I{csrc}", "-o", so,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(so)
    libs["wavepack_gradstream"].wavepack_gradstream_f32.argtypes = \
        _kernels._ENTRY["wavepack_gradstream"][2]
    libs["bcsr"].bcsr_spmm_launch.argtypes = PARENT_BCSR_ARGS
    libs["row_fold"].row_fold_launch.argtypes = PARENT_FOLD_ARGS
    return libs


def build_sweep(out_dir: str) -> dict:
    """The SWEEP variants of this checkout's gradient stream, compiled in
    parallel; returns (library, correct) by name."""
    nvcc = _kernels._nvcc()
    with open(os.path.join(_kernels._CSRC, "wavepack_gradstream.cu")) as f:
        base = f.read()
    procs = []
    for name, subs, correct in SWEEP:
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"sweep {name}: {old!r} not in the source")
            src = src.replace(old, new)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(src)
        procs.append((name, correct, os.path.join(d, "k.so"),
                      subprocess.Popen(
                          [nvcc, *_kernels.NVCC_FLAGS, f"-I{_kernels._CSRC}",
                           "-o", os.path.join(d, "k.so"),
                           os.path.join(d, "k.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)))
    libs = {}
    for name, correct, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on sweep {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.wavepack_gradstream_f32.argtypes = \
            _kernels._ENTRY["wavepack_gradstream"][2]
        libs[name] = (lib, correct)
    return libs


def parent_gradstream(lib, vals, idxT, mask, tile_part, tile_block, cmap,
                      g_acc, xt, cfg) -> torch.Tensor:
    out = torch.empty_like(vals)
    rc = lib.wavepack_gradstream_f32(
        vals.data_ptr(), idxT.data_ptr(), int(cfg.idx16),
        int(cfg.steal_mantissa), int(cfg.block_major), mask.data_ptr(),
        tile_part.data_ptr(), tile_block.data_ptr(),
        None if cmap is None else cmap.data_ptr(), g_acc.data_ptr(),
        xt.data_ptr(), out.data_ptr(), vals.shape[0], vals.shape[1],
        _n_ops(cfg), cfg.classes_per_group, xt.shape[1],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent gradstream: CUDA error {rc}")
    return out


def parent_bcsr(lib, blocks, brow_ptr, bcol, x) -> torch.Tensor:
    nbr = brow_ptr.shape[0] - 1
    out = torch.empty(nbr * 128, x.shape[1], dtype=torch.float32,
                      device=x.device)
    rc = lib.bcsr_spmm_launch(
        blocks.data_ptr(), int(blocks.dtype == torch.bfloat16),
        brow_ptr.data_ptr(), bcol.data_ptr(), x.data_ptr(), out.data_ptr(),
        nbr, x.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent bcsr: CUDA error {rc}")
    return out


def parent_fold(lib, y, idx, ptr, long_rows, alg="plus_times"):
    """The parent's fold of y (n_ren,) or (F, n_ren)."""
    n = ptr.shape[0] - 1
    out = torch.empty(y.shape[:-1] + (n,), dtype=torch.float32,
                      device=y.device)
    rc = lib.row_fold_launch(
        y.data_ptr(), idx.data_ptr(), ptr.data_ptr(),
        long_rows.data_ptr() if long_rows.numel() else None, out.data_ptr(),
        n, long_rows.shape[0], y.shape[-1], y.shape[0] if y.dim() == 2
        else 1, FOLD_THREAD_MAX, _kernels.FOLD_ALGEBRAS[alg],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent row_fold: CUDA error {rc}")
    return out


def parent_plan(parent: str, op, dev, tmp: str) -> tuple:
    """``op``'s fold plan (idx, ptr, long_rows) as the parent checkout's
    own ``fold_plan`` makes it, in a fresh process there; on ``dev``."""
    src, dst = os.path.join(tmp, "perm.npz"), os.path.join(tmp, "plan.npz")
    np.savez(src, perm=op.wp.perm, num_rows=op.wp.num_rows)
    run = subprocess.run([sys.executable, "-c", PLAN_CODE, src, dst],
                         cwd=parent, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"the parent's fold_plan failed:\n{run.stderr}")
    with np.load(dst) as z:
        return tuple(torch.from_numpy(z[f"arr_{i}"].astype(np.int32)).to(dev)
                     for i in range(3))


def hub_order(plan) -> str:
    """How a fold plan orders its hub rows."""
    ptr, hubs = plan[1].cpu().numpy(), plan[2].cpu().numpy()
    if (np.diff(hubs) > 0).all():
        return "ascending"
    if (np.diff(ptr[hubs + 1] - ptr[hubs]) <= 0).all():
        return "longest first"
    return "other"


def fold_turns(lib, parent: str, dev) -> dict:
    """The fold, parent against change, each on its own checkout's plan,
    on googleplus's renamed y (F = 1), the GCN's A-hat at F = 16 (the
    change on (n, F), its matmul's layout, and on (F, n), the parent's)
    and a min_plus hub-split pack (the 100k app graph at split 16,
    chip_smoke.py's phase 10 operator), outputs bit for bit."""
    m = powerlaw_csr(*GOOGLEPLUS["shape"], seed=GOOGLEPLUS["seed"])
    cfg = SpmvConfig(**GOOGLEPLUS_CFG)
    graph = powerlaw_csr(*APPS_100K["shape"], alpha=APPS_100K["alpha"],
                         seed=APPS_100K["seed"])
    rng = np.random.default_rng(0)
    result = {}
    for tag, mat, F, c, pk in (
            ("googleplus F=1", m, 1, cfg, GOOGLEPLUS_PACK),
            ("gcn A-hat F=16", gcn_normalize(m), GCN_F, cfg,
             GOOGLEPLUS_PACK),
            ("min_plus 100k split 16", graph, 1,
             SpmvConfig(semiring="min_plus"), dict(split_max=APPS_SPLIT))):
        op = SpmvOperator(pack(mat, c, **pk), dev)
        plan = (op.fold_idx, op.fold_ptr, op.fold_long)
        with tempfile.TemporaryDirectory() as tmp:
            pplan = parent_plan(parent, op, dev, tmp)
        alg = c.semiring
        if F == 1:
            x = torch.from_numpy(rng.random(mat.num_cols).astype(
                np.float32)).to(dev)
            y_in = y_out = op(x, renamed=True)
            calls = {"parent": lambda: parent_fold(lib, y_out, *pplan, alg),
                     "change": lambda: row_fold(y_in, *plan, alg)}
        else:
            H = torch.from_numpy(rng.standard_normal(
                (mat.num_cols, F)).astype(np.float32)).to(dev)
            y_in = op.matmul(H, renamed=True).T       # (n_ren, F)
            y_out = y_in.T.contiguous()               # (F, n_ren)
            calls = {"parent": lambda: parent_fold(lib, y_out, *pplan, alg),
                     "change": lambda: row_fold(y_in, *plan, alg, dim=0),
                     "change (F, n)": lambda: row_fold(y_out, *plan, alg)}
        ref = calls["parent"]()
        outs = {k: c() for k, c in calls.items()}
        outs["change"] = outs["change"].T if F > 1 else outs["change"]
        same = all(torch.equal(o.view(torch.int32), ref.view(torch.int32))
                   for o in outs.values())
        print(f"fold {tag}: {op.fold_idx.numel()} partials, "
              f"{op.fold_long.numel()} hub rows (the parent's plan: "
              f"{hub_order(pplan)}, the change's: {hub_order(plan)}), "
              f"parent == change {same}", flush=True)
        if not same:
            raise RuntimeError(f"fold {tag}: the kernels differ")
        result[f"row_fold {tag}"] = turns(f"row_fold {tag}", calls)
        del op
    return result


def e2e_sample(root: str, path: str) -> dict:
    """One fresh process in the checkout ``root``: its GCN's matmul and
    step on the matrix in ``path``."""
    run = subprocess.run(
        [sys.executable, "-c", E2E_CODE, path, json.dumps(GCN_DIMS),
         json.dumps(GOOGLEPLUS_CFG), json.dumps(GOOGLEPLUS_PACK)],
        cwd=root, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"e2e in {root} failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def paired(parent: list, change: list) -> dict:
    """The means, the paired differences' mean and standard error
    (parent - change), the pairs the change won, and the verdict: "change
    faster" beyond twice the standard error, "change slower" below minus
    twice it, else "unresolved"."""
    diff = [p - c for p, c in zip(parent, change)]
    mean = statistics.fmean(diff)
    se = statistics.stdev(diff) / len(diff) ** 0.5
    return {"parent_ms": parent, "change_ms": change,
            "mean_parent_ms": statistics.fmean(parent),
            "mean_change_ms": statistics.fmean(change),
            "mean_diff_ms": mean, "se_diff_ms": se,
            "change_won": sum(d > 0 for d in diff),
            "verdict": ("change faster" if mean > 2 * se
                        else "change slower" if mean < -2 * se
                        else "unresolved")}


def e2e_turns(parent_root: str, change_root: str,
              pairs: int = PAIRS) -> dict:
    """The natural-order matmul and the GCN step, a fresh process a
    sample: a warm-up a side (dropped), then ``pairs`` pairs whose first
    side alternates; returns :func:`paired` of each metric."""
    roots = {"parent": parent_root, "change": change_root}
    m = powerlaw_csr(*GOOGLEPLUS["shape"], seed=GOOGLEPLUS["seed"])
    samples: dict = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "googleplus.npz")
        save_npz(path, m)
        del m
        for k, root in roots.items():
            rec = e2e_sample(root, path)
            print(f"e2e warm-up {k} (dropped): matmul "
                  f"{rec['matmul_natural_ms']:.4f} ms, gcn step "
                  f"{rec['gcn_step_ms']:.4f} ms", flush=True)
        for i in range(pairs):
            order = ("parent", "change") if i % 2 == 0 else \
                ("change", "parent")
            for k in order:
                samples[k].append(e2e_sample(roots[k], path))
            p, c = samples["parent"][-1], samples["change"][-1]
            print(f"e2e pair {i} ({order[0]} first): gcn A-hat matmul "
                  f"F={GCN_F} natural parent {p['matmul_natural_ms']:.4f} / "
                  f"change {c['matmul_natural_ms']:.4f} ms, gcn step parent "
                  f"{p['gcn_step_ms']:.4f} / change {c['gcn_step_ms']:.4f} "
                  f"ms", flush=True)
    result = {}
    for metric in ("matmul_natural_ms", "gcn_step_ms"):
        res = paired([r[metric] for r in samples["parent"]],
                     [r[metric] for r in samples["change"]])
        print(f"e2e {metric}: means parent {res['mean_parent_ms']:.4f}, "
              f"change {res['mean_change_ms']:.4f}; parent - change "
              f"{res['mean_diff_ms']:.4f} (standard error "
              f"{res['se_diff_ms']:.4f}); change won {res['change_won']} of "
              f"{pairs}; verdict: {res['verdict']}", flush=True)
        result[metric] = res
    return result


def turns(name: str, calls: dict, reps: int = 50) -> dict:
    """Times each call in the order parent, change, the other calls,
    change, parent and returns the median of each one's turns."""
    times: dict = {k: [] for k in calls}
    others = [k for k in calls if k not in ("parent", "change")]
    for k in ["parent", "change"] + others + ["change", "parent"]:
        ms = device_time_ms(calls[k], reps=reps, queued=True)
        times[k].append(ms)
        print(f"time {name:26s} {k:6s} {ms:.4f} ms", flush=True)
    return {k: statistics.median(v) for k, v in times.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier whole checkout")
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="comma-separated kernels to time, of "
                         f"{','.join(KERNELS)}")
    ap.add_argument("--e2e", action="store_true",
                    help="also time the parent's GCN matmul and step "
                         "beside this checkout's, in pairs")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the gradient stream's SWEEP variants")
    ap.add_argument("--build", default=os.path.join(
        _kernels._BUILD, "parent_ab"), help="where to build the parent's")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(KERNELS):
        raise SystemExit(f"--only takes kernels of {KERNELS}")
    if not torch.cuda.is_available():
        raise SystemExit("parent_ab needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    parent = os.path.abspath(args.parent)
    libs = build_parent(parent, args.build)
    sweep = build_sweep(os.path.join(args.build, "sweep")) if args.sweep \
        else {}
    _kernels.load()
    dev = torch.device("cuda")
    result = {"device": smi}

    if "row_fold" in only:
        result.update(fold_turns(libs["row_fold"], parent, dev))
    if args.e2e:
        result["e2e"] = e2e_turns(parent, os.path.dirname(_kernels._PKG))
    if "gradstream" in only:
        result.update(gradstream_turns(libs, sweep, dev))
    if "bcsr" in only:
        result.update(bcsr_turns(libs, dev))
    print(json.dumps(result), flush=True)


def gradstream_turns(libs, sweep, dev) -> dict:
    """The gradient stream, parent against change (and the sweep's
    variants), on the transformer-70 packs A and A^T."""
    result = {}
    cfg = SpmvConfig(**T70_CFG)
    m70 = uniform_sparse_csr(*T70["shape"], seed=T70["seed"])
    sd = StreamDiffSpmv(m70, cfg, SpmvConfig(**dict(T70_CFG, stripes=512)),
                        device=dev, split_max=None)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(sd.num_cols).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(sd.num_rows).astype(
        np.float32)).to(dev)
    for tag, ops in (("A", (sd.d.op, sd.vA.detach(), sd.maskA, g, x)),
                     ("A^T", (sd.d.opT, sd.vT.detach(), sd.maskT, x, g))):
        gargs = grad_stream_operands(*ops)
        lib = libs["wavepack_gradstream"]
        calls = {"parent": lambda: parent_gradstream(lib, *gargs),
                 "change": lambda: wavepack_gradstream(*gargs)}
        ref = calls["change"]().view(torch.int32)
        same = torch.equal(calls["parent"]().view(torch.int32), ref)
        print(f"gradstream transformer-70 {tag}: {gargs[0].shape[0]} tiles, "
              f"parent == change {same}", flush=True)
        if not same:
            raise RuntimeError(f"gradstream {tag}: the kernels differ")
        for name, (vlib, correct) in sweep.items():
            calls[name] = (lambda vl: lambda: parent_gradstream(
                vl, *gargs))(vlib)
            if correct and not torch.equal(calls[name]().view(torch.int32),
                                           ref):
                raise RuntimeError(f"gradstream {tag}: {name} differs")
        result[f"gradstream_{tag}"] = turns(f"gradstream t70 {tag}", calls)
    return result


def bcsr_turns(libs, dev) -> dict:
    """BCSR, parent against change, on bcsr-spmm-16k, bf16, 64
    right-hand sides."""
    m = block_structured_csr(*BCSR16K["shape"],
                             block_rows=BCSR16K["block_rows"],
                             seed=BCSR16K["seed"])
    op = BcsrOperator(m, torch.bfloat16, device=dev)
    X = torch.from_numpy(np.random.default_rng(1).random(
        (m.num_cols, BCSR_RHS)).astype(np.float32)).to(dev)
    bargs = (op.blocks, op.brow_ptr, op.bcol, op.padded_x(X))
    calls = {"parent": lambda: parent_bcsr(libs["bcsr"], *bargs),
             "change": lambda: bcsr_spmm(*bargs)}
    yp, yc = calls["parent"](), calls["change"]()
    err = float((yp - yc).abs().max() / yp.abs().max())
    print(f"bcsr bcsr-spmm-16k: {op.blocks.shape[0]} blocks, change vs "
          f"parent {err:.3e} of max|Y| (gate 1e-4)", flush=True)
    if not err <= 1e-4:
        raise RuntimeError(f"bcsr: change vs parent {err}")
    return {"bcsr_16k": dict(turns("bcsr bcsr-spmm-16k", calls),
                             rel_err=err)}


if __name__ == "__main__":
    sys.exit(main())
