"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, in the gitignored
``hisparse_tpu_torch/_build/`` directory, at first use; the sources build
in parallel, one ``nvcc`` each.  The libraries sit in a directory named by
a hash of every ``.cu`` and ``.cuh`` source, so an edited source or header
rebuilds all of them.  They are loaded with ``ctypes``; every pointer and
the stream pass as ``c_void_p``.  Nothing is built at import: the module
is also imported on machines without ``nvcc`` or a GPU, where only the
plain versions run.

Each kernel has its own launch counter, raised by one per launch made
through its ``launch_*`` function, so a run can show that its main path
went through the kernel: ``launches`` (the wavepack SpMV),
``gradstream_launches``, ``spmm_launches``, ``masked_launches``,
``bcsr_launches`` and ``fold_launches`` (the renamed -> natural fold).
``spmm_wide_launches`` counts, among ``spmm_launches``, those of the wide
SpMM instantiation (an xt of more than ``SPMM_NARROW_F`` features).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
# one shared library per csrc/<name>.cu
LIBRARIES = ("wavepack_spmv", "wavepack_gradstream", "bcsr", "row_fold")
# --split-compile=0 optimises the kernels' template instantiations (50 in
# wavepack_spmv.cu) on every core
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# each kernel's library, C entry point and argument types; SpMV, SpMM and
# the masked SpMV are one kernel body of wavepack_spmv.cu
_ENTRY = {
    "wavepack_spmv": ("wavepack_spmv", "wavepack_spmv_launch",
                      [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P]),
    "wavepack_gradstream": ("wavepack_gradstream", "wavepack_gradstream_f32",
                            [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _P]),
    "wavepack_spmm": ("wavepack_spmv", "wavepack_spmm_launch",
                      [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P]),
    "wavepack_spmv_masked": ("wavepack_spmv", "wavepack_spmv_masked_launch",
                             [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "bcsr": ("bcsr", "bcsr_spmm_launch",
             [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "row_fold": ("row_fold", "row_fold_launch",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
}
KERNELS = tuple(_ENTRY)
# wavepack_spmv.cu's report on the instantiation an entry point launches
_INFO = ("wavepack_spmv", "wavepack_kernel_info", [_I] * 9 + [_P])
# row_fold.cu's dependent-add timer (the fold's chain floor)
_FADD = ("row_fold", "fadd_latency_launch", [_P, _P, _I, ctypes.c_float, _P])
INFO_FIELDS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
               "ctas_per_sm", "stages", "threads")
# the wavepack kernels' semiring and value-type arguments
# (csrc/wavepack_spmv.cu); the fold's algebra is a semiring or 3, Q8.24
# (csrc/row_fold.cu)
SEMIRINGS = {"plus_times": 0, "min_plus": 1, "max_times": 2}
FOLD_ALGEBRAS = dict(SEMIRINGS, fixed=3)
VTYPES = {"fp32": 0, "bf16": 1, "fixed": 2}
# the widest xt the SpMM's kF = 4, 8 and 16 instantiations take; a wider
# one launches the wide instantiation (kMaxF and pick() in
# csrc/wavepack_spmv.cu)
SPMM_NARROW_F = 16

_lock = threading.Lock()
_fns = None
launches = 0
gradstream_launches = 0
spmm_launches = 0
spmm_wide_launches = 0
masked_launches = 0
bcsr_launches = 0
fold_launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "hisparse_tpu_torch's kernels")


def build_dir() -> str:
    """``_build/kernels-<hash of every .cu and .cuh source>``."""
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                       + glob.glob(os.path.join(_CSRC, "*.cuh"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(_BUILD, f"kernels-{digest.hexdigest()[:16]}")


def _build(out_dir: str) -> None:
    """Compile every library that is not built yet, one nvcc each, all
    started together; raise with the compiler's output if one fails."""
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in LIBRARIES:
        so = os.path.join(out_dir, f"{name}.so")
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        src = os.path.join(_CSRC, f"{name}.cu")
        procs.append((src, so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {src}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def register_counts() -> dict:
    """Registers per thread of every compiled kernel, by mangled name, as
    ``ptxas -v`` reports them: each library source compiled once more, in
    parallel, with ``-Xptxas -v`` into a scratch file of the build
    directory.  Needs nvcc; for the record, not for the kernels' use."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    tmps = [os.path.join(out_dir, f"{name}.ptxas.{os.getpid()}.tmp")
            for name in LIBRARIES]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
         os.path.join(_CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, tmp in zip(LIBRARIES, tmps)]
    counts, kernel = {}, None
    for name, tmp, proc in zip(LIBRARIES, tmps, procs):
        log = proc.communicate()[0]
        if os.path.exists(tmp):
            os.remove(tmp)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed on {name}.cu:\n{log}")
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                counts[kernel] = int(m.group(1))
                kernel = None
    return counts


def load() -> dict:
    """Build (if a source changed) and load every kernel; returns the C
    entry points by kernel name."""
    global _fns
    with _lock:
        if _fns is not None:
            return _fns
        out_dir = build_dir()
        _build(out_dir)
        libs = {name: ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
                for name in LIBRARIES}
        fns = {}
        for name, (lib, entry, argtypes) in _ENTRY.items():
            fn = getattr(libs[lib], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        for key, (lib, entry, argtypes) in (("kernel_info", _INFO),
                                            ("fadd_latency", _FADD)):
            fn = getattr(libs[lib], entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[key] = fn
        _fns = fns
        return fns


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t) -> int | None:
    return t.data_ptr() if t is not None else None


def launch_wavepack_spmv(vals, idxT, tile_part, cmap, run_start, run_end,
                         xt, out, *, semiring: str, dtype: str, steal: bool,
                         block_major: bool, n_ops: int, K: int) -> None:
    """Launch the SpMV kernel on the current stream; ``dtype`` is the
    pack's value type.  The caller has checked device, dtype, shape and
    contiguity (ops/spmv.py:wavepack_spmv)."""
    global launches
    rc = load()["wavepack_spmv"](
        vals.data_ptr(), idxT.data_ptr(), int(idxT.dtype == torch.int16),
        int(steal), int(block_major), SEMIRINGS[semiring], VTYPES[dtype],
        tile_part.data_ptr(), _ptr(cmap), run_start.data_ptr(),
        run_end.data_ptr(), xt.data_ptr(), out.data_ptr(),
        run_start.shape[0], vals.shape[1], n_ops, K, xt.shape[1],
        _stream(vals))
    _check("wavepack_spmv", rc)
    launches += 1


def launch_wavepack_spmv_masked(vals, idxT, tile_ids, tile_part, cmap,
                                run_start, run_end, xt, out, *,
                                semiring: str, dtype: str, steal: bool,
                                block_major: bool, n_ops: int,
                                K: int) -> None:
    """Launch the masked SpMV kernel on the current stream (checked by
    ops/spmv.py:wavepack_spmv_masked); the runs index ``tile_ids``."""
    global masked_launches
    rc = load()["wavepack_spmv_masked"](
        vals.data_ptr(), idxT.data_ptr(), int(idxT.dtype == torch.int16),
        int(steal), int(block_major), SEMIRINGS[semiring], VTYPES[dtype],
        tile_ids.data_ptr(), tile_part.data_ptr(), _ptr(cmap),
        run_start.data_ptr(), run_end.data_ptr(), xt.data_ptr(),
        out.data_ptr(), run_start.shape[0], vals.shape[1], n_ops, K,
        xt.shape[1], _stream(vals))
    _check("wavepack_spmv_masked", rc)
    masked_launches += 1


def launch_wavepack_gradstream(vals, idxT, mask, tile_part, tile_block,
                               cmap, g_acc, xt, out, *, steal: bool,
                               block_major: bool, n_ops: int,
                               K: int) -> None:
    """Launch the gradient-stream kernel on the current stream (checked by
    ops/spmv.py:wavepack_gradstream)."""
    global gradstream_launches
    rc = load()["wavepack_gradstream"](
        vals.data_ptr(), idxT.data_ptr(), int(idxT.dtype == torch.int16),
        int(steal), int(block_major), mask.data_ptr(),
        tile_part.data_ptr(), tile_block.data_ptr(), _ptr(cmap),
        g_acc.data_ptr(), xt.data_ptr(), out.data_ptr(), vals.shape[0],
        vals.shape[1], n_ops, K, xt.shape[1], _stream(vals))
    _check("wavepack_gradstream", rc)
    gradstream_launches += 1


def kernel_info(which: str, *, semiring: str, dtype: str, idx16: bool,
                steal: bool, block_major: bool, Fp: int = 1,
                n_blocks: int = 1, S: int = 512) -> dict:
    """What the instantiation that kernel ``which`` (``"wavepack_spmv"``,
    ``"wavepack_spmv_masked"`` or ``"wavepack_spmm"`` at Fp features)
    launches for these pack flags and a pack of n_blocks row blocks of S
    sublanes (which set the SpMV's CTA shape) uses on this card:
    ``INFO_FIELDS``, from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor.  Raises for flags no
    instantiation takes."""
    kinds = ("wavepack_spmv", "wavepack_spmv_masked", "wavepack_spmm")
    out = (ctypes.c_int * len(INFO_FIELDS))()
    _check(f"{which} info", load()["kernel_info"](
        kinds.index(which), SEMIRINGS[semiring], VTYPES[dtype], int(idx16),
        int(steal), int(block_major), Fp, n_blocks, S, out))
    return dict(zip(INFO_FIELDS, out))


def launch_wavepack_spmm(vals, idxT, tile_part, cmap, run_start, run_end,
                         xt, out, *, semiring: str, dtype: str, steal: bool,
                         block_major: bool, n_ops: int, K: int) -> None:
    """Launch the SpMM kernel on the current stream (checked by
    ops/spmv.py:wavepack_spmm): xt is (n_parts, CT, 128, 128, Fp), out
    (F, n_blocks*S, 128) with F <= Fp."""
    global spmm_launches, spmm_wide_launches
    rc = load()["wavepack_spmm"](
        vals.data_ptr(), idxT.data_ptr(), int(idxT.dtype == torch.int16),
        int(steal), int(block_major), SEMIRINGS[semiring], VTYPES[dtype],
        tile_part.data_ptr(), _ptr(cmap), run_start.data_ptr(),
        run_end.data_ptr(), xt.data_ptr(), out.data_ptr(),
        run_start.shape[0], vals.shape[1], n_ops, K, xt.shape[1],
        out.shape[0], xt.shape[4], _stream(vals))
    _check("wavepack_spmm", rc)
    spmm_launches += 1
    if xt.shape[4] > SPMM_NARROW_F:
        spmm_wide_launches += 1


def launch_bcsr(blocks, brow_ptr, bcol, x, out) -> None:
    """Launch the BCSR kernel on the current stream (checked by
    ops/bcsr.py:bcsr_spmm): blocks (nb, 128, 128) bf16 or fp32, x
    (nbc*128, kp) of the same dtype, out (nbr*128, kp) fp32."""
    global bcsr_launches
    rc = load()["bcsr"](
        blocks.data_ptr(), int(blocks.dtype == torch.bfloat16),
        brow_ptr.data_ptr(), bcol.data_ptr(), x.data_ptr(), out.data_ptr(),
        brow_ptr.shape[0] - 1, blocks.shape[0], x.shape[0], x.shape[1],
        _stream(blocks))
    _check("bcsr", rc)
    bcsr_launches += 1


def launch_row_fold(y, idx, ptr, long_rows, out, *, alg: str,
                    thread_max: int, inner: bool) -> None:
    """Launch the fold kernel on the current stream (checked by
    ops/spmv.py:row_fold): ``inner`` y (n_renamed, F) and out (n_rows, F),
    else y (n_renamed,) or (F, n_renamed) and out (n_rows,) or (F,
    n_rows); float32 or Q8.24 words in int32; idx, ptr (n_rows + 1,) and
    long_rows int32 (ops/spmv.py:fold_plan), long_rows the rows of more
    than ``thread_max`` partials."""
    global fold_launches
    if y.dim() == 1:
        F, n_ren = 1, y.shape[0]
    else:
        n_ren, F = y.shape if inner else y.shape[::-1]
    rc = load()["row_fold"](
        y.data_ptr(), idx.data_ptr(), ptr.data_ptr(), _ptr(long_rows)
        if long_rows.numel() else None, out.data_ptr(), ptr.shape[0] - 1,
        long_rows.shape[0], n_ren, F, int(inner), thread_max,
        FOLD_ALGEBRAS[alg], _stream(y))
    _check("row_fold", rc)
    fold_launches += 1


def fadd_latency_cycles(n: int = 1 << 16) -> float:
    """SM clocks of one dependent fp32 add on this card: ``n`` adds in a
    chain on one thread (``csrc/row_fold.cu``), timed with the SM's clock.
    Not a kernel of any path: the fold's chain floor reads it."""
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.float32, device="cuda")
    _check("fadd_latency", load()["fadd_latency"](
        cycles.data_ptr(), sink.data_ptr(), n, 1.0, _stream(cycles)))
    return int(cycles.item()) / n
