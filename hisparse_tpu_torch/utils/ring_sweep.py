"""Time shapes of the wavepack SpMV kernel's tile pipeline on one GPU.

    python -m hisparse_tpu_torch.utils.ring_sweep [--parent DIR]

Builds variants of ``csrc/wavepack_spmv.cu`` that differ in the sublanes
a CTA owns at kF = 1 (4 or 8, launched whatever the grid) and in the
tiles its ring keeps in flight (``kStepsAhead``: 1, 2 or 3), plus 8
sublanes and 2 ahead with the x gathers replaced by a value made from
the address (the stream alone, not a correct product), each with only
the instantiations timed.
``--parent DIR`` adds the kernel of an earlier checkout (DIR holds its
``wavepack_spmv.cu`` and ``route.cuh``, with the same SpMV and masked C
entry points), for instance the parent commit unpacked with ``git
archive``.  Each variant is timed on the SpMV shapes of ``chip_smoke.py``:
googleplus (block-major idx16 steal), the 4-partition PageRank pack, the
SSSP pokec pack (min_plus), the masked pokec call over the tiles of a
random 10% of the columns, and the transformer-70 training pack A (one
row block), with CUDA events and the host enqueue held out
(``utils/bench.device_time_ms(queued=True)``), the parent first and last;
every correct variant's output is checked bit-equal to the first one
timed.  Prints one line a (shape, variant) and the card's name and power
limit; needs nvcc and a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import powerlaw_csr, rmat_csr, uniform_sparse_csr
from ..formats.wavepack import pack
from ..models.apps import SSSP, PageRank
from ..ops import _kernels
from ..ops.spmv import SpmvOperator, _n_ops
from .bench import (APPS_100K, GOOGLEPLUS, GOOGLEPLUS_CFG, GOOGLEPLUS_PACK,
                    POKEC, T70, T70_CFG, device_time_ms)

# the instantiations timed: googleplus, plus_times chain (PageRank),
# min_plus chain (pokec), its masked form, and plus_times chain idx16
# (transformer-70)
ENTRY = r'''
extern "C" int sweep_launch(int which, const void* vals, const void* idxT,
    const void* tile_ids, const void* tile_part, const void* cmap,
    const void* run_start, const void* run_end, const void* xt, void* out,
    int n_blocks, int S, int n_ops, int K, int CT, void* stream) {
  const Params p = make_params(vals, idxT, tile_ids, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1, 1);
  constexpr int R = SWEEP_ROWS;
  constexpr int P = kPlusTimes, M = kMinPlus;
  const Kernel k =
      which == 0 ? fn<uint32_t, int16_t, true, true, 1, P, false, R>()
    : which == 1 ? fn<uint32_t, int32_t, false, false, 1, P, false, R>()
    : which == 2 ? fn<uint32_t, int32_t, false, false, 1, M, false, R>()
    : which == 3 ? fn<uint32_t, int32_t, false, false, 1, M, true, R>()
                 : fn<uint32_t, int16_t, true, false, 1, P, false, R>();
  return launch(Choice{k, R}, p, static_cast<cudaStream_t>(stream));
}
'''
ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"ring_sweep: {old!r} not in the kernel source")
    return src.replace(old, new)


def variant_source(rows: int, ahead: int, gather: bool = True) -> str:
    """The kernel source at ``rows`` sublanes a CTA and ``ahead`` tiles in
    flight, cut to the timed instantiations."""
    with open(os.path.join(_kernels._CSRC, "wavepack_spmv.cu")) as f:
        src = f.read()
    src = _replace(src, "constexpr int kStepsAhead = 2;",
                   f"constexpr int kStepsAhead = {ahead};")
    if not gather:
        src = _replace(
            src, "combine<kSr>(acc[0], v, __ldg(xt + slot))",
            "combine<kSr>(acc[0], v, __uint_as_float(static_cast<uint32_t>("
            "slot) & 0x3fffffffu))")
    cut = src.index("// The instantiation for the run-time semiring")
    keep = src[src.index("// Launches c's kernel"):
               src.index("}  // namespace")]
    return (f"#define SWEEP_ROWS {rows}\n" + src[:cut] + keep
            + "}  // namespace\n" + ENTRY)


def build(variants: dict, parent: str | None, out_dir: str) -> dict:
    """Compile every variant (and the parent's full source) in parallel;
    returns the loaded libraries by name."""
    nvcc = _kernels._nvcc()
    flags = [f for f in _kernels.NVCC_FLAGS if f != "--split-compile=0"]
    procs = []
    for name, src in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(src)
        procs.append((name, d, subprocess.Popen(
            [nvcc, *flags, f"-I{_kernels._CSRC}", "-Xptxas", "-v", "-o",
             os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    if parent:
        d = os.path.join(out_dir, "parent")
        os.makedirs(d, exist_ok=True)
        procs.append(("parent", d, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, f"-I{parent}", "-o",
             os.path.join(d, "k.so"),
             os.path.join(parent, "wavepack_spmv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, d, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        if regs:
            print(f"build {name}: registers {'/'.join(regs)}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "k.so"))
        if name == "parent":
            lib.wavepack_spmv_launch.argtypes = \
                _kernels._ENTRY["wavepack_spmv"][2]
            lib.wavepack_spmv_masked_launch.argtypes = \
                _kernels._ENTRY["wavepack_spmv_masked"][2]
        else:
            lib.sweep_launch.argtypes = ARGS
        libs[name] = lib
    return libs


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(lib, name, which, args, cfg, out, tile_ids=None) -> None:
    v, idx, part, cmap, rs, re_, xt = args
    stream = torch.cuda.current_stream().cuda_stream
    dims = (rs.shape[0], v.shape[1], _n_ops(cfg), cfg.classes_per_group,
            xt.shape[1], stream)
    if name == "parent":
        flags = (_ptr(v), _ptr(idx), int(cfg.idx16), int(cfg.steal_mantissa),
                 int(cfg.block_major), _kernels.SEMIRINGS[cfg.semiring], 0)
        tail = (_ptr(part), _ptr(cmap), _ptr(rs), _ptr(re_), _ptr(xt),
                _ptr(out)) + dims
        rc = (lib.wavepack_spmv_launch(*flags, *tail) if tile_ids is None
              else lib.wavepack_spmv_masked_launch(*flags, _ptr(tile_ids),
                                                   *tail))
    else:
        rc = lib.sweep_launch(which, _ptr(v), _ptr(idx), _ptr(tile_ids),
                              _ptr(part), _ptr(cmap), _ptr(rs), _ptr(re_),
                              _ptr(xt), _ptr(out), *dims)
    if rc:
        raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")


def shapes(dev) -> list:
    """(name, instantiation, operands, config, tile ids) of every timed
    call."""
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    m = powerlaw_csr(*GOOGLEPLUS["shape"], seed=GOOGLEPLUS["seed"])
    op = SpmvOperator(pack(m, SpmvConfig(**GOOGLEPLUS_CFG),
                           **GOOGLEPLUS_PACK), device=dev)
    pr = PageRank(powerlaw_csr(*APPS_100K["shape"], alpha=APPS_100K["alpha"],
                               seed=APPS_100K["seed"]), device=dev)
    ss = SSSP(rmat_csr(*POKEC["shape"], seed=POKEC["seed"]), device=dev)
    print(f"shapes built in {time.perf_counter() - t0:.1f} s", flush=True)

    def x_of(o):
        return o.stream_args(torch.rand(o.wp.num_cols, generator=g,
                                        device=dev))

    out = [("googleplus", 0, x_of(op), op.cfg, None),
           ("pagerank-pack", 1, x_of(pr.op), pr.op.cfg, None),
           ("pokec", 2, x_of(ss.op), ss.op.cfg, None)]
    active = np.flatnonzero(np.random.default_rng(0).random(
        ss.op.wp.num_cols) < 0.1)
    margs = ss.op.masked_args(torch.rand(ss.op.wp.num_cols, generator=g,
                                         device=dev),
                              ss.op.active_tiles(active))
    out.append(("pokec-masked", 3, margs[:2] + margs[3:], ss.op.cfg,
                margs[2]))
    m70 = uniform_sparse_csr(*T70["shape"], seed=T70["seed"])
    t70 = SpmvOperator(pack(m70, SpmvConfig(**T70_CFG), split_max=None),
                       device=dev)
    out.append(("transformer-70 A", 4, x_of(t70), t70.cfg, None))
    for name, _, args, _, _ in out:
        runs = (args[5] - args[4]).cpu().numpy()
        print(f"shape {name}: tiles {args[0].shape[0]}, blocks {runs.size}, "
              f"run max {runs.max()} mean {runs.mean():.1f}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="csrc directory of an earlier kernel to time too")
    ap.add_argument("--build", default=os.path.join(
        _kernels._BUILD, "ring_sweep"), help="where to build the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ring_sweep needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {f"rows{r}-ahead{a}": variant_source(r, a)
                for r in (4, 8) for a in (1, 2, 3)}
    variants["rows8-ahead2-no-gather"] = variant_source(8, 2, gather=False)
    libs = build(variants, args.parent, args.build)
    order = ((["parent"] if args.parent else []) + list(variants)
             + (["parent"] if args.parent else []))
    dev = torch.device("cuda")
    for name, which, sargs, cfg, tile_ids in shapes(dev):
        rows = sargs[4].shape[0] * cfg.sublanes
        first = None
        for v in order:
            out = torch.empty(rows, 128, device=dev)

            def call():
                launch(libs[v], v, which, sargs, cfg, out, tile_ids)

            call()
            torch.cuda.synchronize()
            same = "-"
            if "no-gather" not in v:
                if first is None:
                    first = out.clone()
                else:
                    same = str(torch.equal(out.view(torch.int32),
                                           first.view(torch.int32)))
            ms = device_time_ms(call, reps=20, queued=True)
            print(f"time {name:18s} {v:24s} {ms:.4f} ms  bit-equal {same}",
                  flush=True)
            if same == "False":
                raise RuntimeError(f"{name}: {v} differs from the first")


if __name__ == "__main__":
    sys.exit(main())
