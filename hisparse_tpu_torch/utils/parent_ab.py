"""Time the gradient-stream and BCSR kernels beside an earlier checkout's,
on one GPU, in one process.

    python -m hisparse_tpu_torch.utils.parent_ab --parent DIR

DIR holds an earlier ``csrc/`` (its ``wavepack_gradstream.cu``,
``bcsr.cu`` and ``route.cuh``), for instance the parent commit unpacked
with ``git archive`` into the gitignored ``scratch/``; the parent's C entry
points are ``wavepack_gradstream_f32`` (the current signature) and
``bcsr_spmm_launch(blocks, bf16, brow_ptr, bcol, x, out, nbr, kp,
stream)``.  Both are built with nvcc beside this checkout's kernels
(``ops/_kernels.load``) and timed in turns, parent, change, change,
parent, with CUDA events and the host enqueue held out
(``utils/bench.device_time_ms(queued=True)``), on ``chip_smoke.py``'s
shapes: the gradient stream on the transformer-70 training packs A and
A^T (``StreamDiffSpmv`` at bench.py's configs, through
``grad_stream_operands``), BCSR on bcsr-spmm-16k in bf16 with 64
right-hand sides.  The outputs are checked: the gradient streams bit for
bit against each other, BCSR within 1e-4 of max|Y|.  ``--sweep`` also
times variants of this checkout's gradient stream (``SWEEP``: a ring of
3 items, 512-thread CTAs, and with its x gathers or its stores taken
out, which are not correct products) between the change's two turns.  Prints the
card's name and power limit, one line a (shape, kernel, turn) and, last,
one JSON object of the medians; needs nvcc and a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import block_structured_csr, uniform_sparse_csr
from ..ops import _kernels
from ..ops.bcsr import BcsrOperator, bcsr_spmm
from ..ops.spmv import _n_ops, wavepack_gradstream
from ..ops.train_stream import StreamDiffSpmv, grad_stream_operands
from .bench import device_time_ms

# chip_smoke.py's shapes (bench.py:819-824, :897-921)
T70 = ((512, 33288, int(33288 * 0.30)), 70)
T70_CFG = dict(sublanes=512, bank_blocks=1, stripes=4, steal_mantissa=True,
               idx16=True, two_choice=False)
BCSR16K = ((16384, 16384), 24, 7)
BCSR_RHS = 64
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_BCSR_ARGS = [_P, _I, _P, _P, _P, _P, _I, _I, _P]
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
    """The parent's two libraries, compiled in parallel."""
    nvcc = _kernels._nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in ("wavepack_gradstream", "bcsr"):
        so = os.path.join(out_dir, f"{name}.so")
        procs.append((name, so, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, f"-I{parent}", "-o", so,
             os.path.join(parent, f"{name}.cu")],
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
                    help="csrc directory of the earlier kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the gradient stream's SWEEP variants")
    ap.add_argument("--build", default=os.path.join(
        _kernels._BUILD, "parent_ab"), help="where to build the parent's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("parent_ab needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_parent(args.parent, args.build)
    sweep = build_sweep(os.path.join(args.build, "sweep")) if args.sweep \
        else {}
    _kernels.load()
    dev = torch.device("cuda")
    result = {"device": smi}

    # the gradient stream on the transformer-70 packs
    cfg = SpmvConfig(**T70_CFG)
    sd = StreamDiffSpmv(uniform_sparse_csr(*T70[0], seed=T70[1]), cfg,
                        SpmvConfig(**dict(T70_CFG, stripes=512)),
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
    del sd

    # BCSR on bcsr-spmm-16k, bf16, 64 right-hand sides
    (rows, cols), block_rows, seed = BCSR16K
    m = block_structured_csr(rows, cols, block_rows=block_rows, seed=seed)
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
    result["bcsr_16k"] = dict(turns("bcsr bcsr-spmm-16k", calls),
                              rel_err=err)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
