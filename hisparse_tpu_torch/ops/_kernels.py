"""Build and bind the port's CUDA kernels.

``csrc/wavepack_spmv.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in the gitignored
``hisparse_tpu_torch/_build/`` directory, at first use.  The library's
name carries a hash of the source, so an edited source rebuilds.  It is
loaded with ``ctypes``; every pointer and the stream pass as
``c_void_p``.  Nothing is built at import: the module is also imported
on machines without ``nvcc`` or a GPU, where only the plain versions run.

``launches`` counts the launches of the wavepack SpMV kernel made through
:func:`launch_wavepack_spmv`, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "wavepack_spmv.cu")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "hisparse_tpu_torch's kernels")


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"wavepack_spmv-{digest}.so")


def load() -> ctypes.CDLL:
    """Build (if the source changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {_SRC}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wavepack_spmv_f32.argtypes = [p, p, i, i, i, p, p, p, p, p, p,
                                          i, i, i, i, i, p]
        lib.wavepack_spmv_f32.restype = ctypes.c_int
        _lib = lib
        return lib


def launch_wavepack_spmv(vals, idxT, tile_part, cmap, run_start, run_end,
                         xt, out, *, steal: bool, block_major: bool,
                         n_ops: int, K: int) -> None:
    """Launch the kernel on the current stream.  The caller has checked
    device, dtype, shape and contiguity (ops/spmv.py:wavepack_spmv)."""
    global launches
    lib = load()
    n_blocks = run_start.shape[0]
    S = vals.shape[1]
    rc = lib.wavepack_spmv_f32(
        vals.data_ptr(), idxT.data_ptr(), int(idxT.dtype == torch.int16),
        int(steal), int(block_major), tile_part.data_ptr(),
        cmap.data_ptr() if cmap is not None else None,
        run_start.data_ptr(), run_end.data_ptr(), xt.data_ptr(),
        out.data_ptr(), n_blocks, S, n_ops, K, xt.shape[1],
        torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wavepack_spmv kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
