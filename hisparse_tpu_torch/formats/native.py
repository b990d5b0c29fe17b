"""ctypes loader for the fused C++ wavepack packer (_scheduler.cpp).

The production analog of the reference's C++ preprocessor
(sw/data_formatter.h:465-544) — Python stays the API layer; the whole
per-nonzero pipeline (field computation, radix sort, wave scheduling,
stream emission) runs native in one plan+emit pair.  Compiled on demand
with g++ into the port's build directory (``hisparse_tpu_torch/_build/``,
gitignored); without a toolchain every caller falls back to the
byte-identical pure-Python implementation in formats/wavepack.py.

A copy of ``hisparse_tpu/formats/native.py``; only the build location
differs (and the library is written to a temporary name and renamed into
place, so concurrent first uses never load a half-written file).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_scheduler.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "_scheduler.so")
_lock = threading.Lock()
_lib = None
_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                os.makedirs(_BUILD, exist_ok=True)
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.wp_plan.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                _i64p, _i32p, _u32p, _i64p, _i64p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, _i64p, _i64p, _i64p]
            lib.wp_plan.restype = ctypes.c_int64
            lib.wp_emit_full.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_uint32,
                _u32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i64p]
            lib.wp_emit_full.restype = None
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ptype):
    return a.ctypes.data_as(ptype)


def pack_full(indptr, indices, data, rank, col_rank, cfg,
              n_blocks: int, n_parts: int, min_tile: int = 0,
              bm_win: int = 16, bm_adv: int = 4):
    """Run the fused native pack.  Returns a dict of output arrays
    (vals, idxT, tile metadata, class_map, leftover) or None if the
    native library is unavailable.

    ``rank`` maps each (post-split) row to its renamed id; ``col_rank``
    maps original to packed column ids (or None).  Output is byte-equal
    to the pure-Python pack() path (asserted in tests/test_formats.py).
    """
    lib = _load()
    if lib is None:
        return None
    import time
    prof = os.environ.get("WP_PROF") == "1"
    tp0 = time.perf_counter()
    nnz = int(indptr[-1])
    n_rows = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    val16 = data.dtype.itemsize == 2          # bf16 stream
    if val16:
        data_bits = np.ascontiguousarray(
            data.view(np.uint16).astype(np.uint32))
    else:
        data_bits = np.ascontiguousarray(data).view(np.uint32)
    rank = np.ascontiguousarray(rank, np.int64)
    if col_rank is not None:
        col_rank = np.ascontiguousarray(col_rank, np.int64)
    T = ctypes.c_int64(0)
    nleft = ctypes.c_int64(0)
    opt_waves = ctypes.c_int64(0)
    rc = lib.wp_plan(
        ctypes.c_int64(nnz), ctypes.c_int64(n_rows),
        _ptr(indptr, _i64p), _ptr(indices, _i32p), _ptr(data_bits, _u32p),
        _ptr(rank, _i64p),
        _ptr(col_rank, _i64p) if col_rank is not None else None,
        ctypes.c_int32(n_blocks), ctypes.c_int32(n_parts),
        ctypes.c_int32(cfg.stripes), ctypes.c_int32(cfg.sublanes),
        ctypes.c_int32(cfg.bank_blocks),
        ctypes.c_int32(int(cfg.two_choice)),
        ctypes.c_int32(int(cfg.block_major)),
        ctypes.c_int32(cfg.classes_per_group),
        ctypes.c_int32(bm_win), ctypes.c_int32(bm_adv),
        ctypes.c_int64(min_tile),
        ctypes.byref(T), ctypes.byref(nleft), ctypes.byref(opt_waves))
    if rc != 0:
        return None
    tp1 = time.perf_counter()
    T, nleft = int(T.value), int(nleft.value)
    S, G, K = cfg.sublanes, cfg.groups, cfg.classes_per_group
    val_dtype = data.dtype if cfg.dtype in ("fixed", "bf16") else np.float32
    vals = np.empty((T, S, 128), val_dtype)
    idx16 = getattr(cfg, "idx16", False)
    idxT = np.empty((T, S, 128), np.int16 if idx16 else np.int32)
    t_block = np.empty(T, np.int32)
    t_part = np.empty(T, np.int32)
    t_first = np.empty(T, np.int32)
    t_last = np.empty(T, np.int32)
    cmap = (np.empty((T, G, K), np.int32) if cfg.block_major else None)
    leftover = np.empty(nleft, np.int64)
    pad = (np.float32(np.inf) if cfg.semiring == "min_plus"
           else val_dtype.type(0) if hasattr(val_dtype, "type")
           else np.float32(0))
    pad_bits = int(np.asarray(pad).view(
        np.uint16 if val16 else np.uint32))
    tp2 = time.perf_counter()
    lib.wp_emit_full(
        ctypes.c_int32(int(cfg.steal_mantissa)), ctypes.c_int32(int(val16)),
        ctypes.c_int32(int(idx16)), ctypes.c_uint32(pad_bits),
        _ptr(vals.view(np.uint16 if val16 else np.uint32), _u32p),
        idxT.ctypes.data_as(_i32p),    # C++ reinterprets as u16 when idx16
        _ptr(t_block, _i32p), _ptr(t_part, _i32p),
        _ptr(t_first, _i32p), _ptr(t_last, _i32p),
        _ptr(cmap, _i32p) if cmap is not None else None,
        _ptr(leftover, _i64p) if nleft else None)
    if prof:
        import sys
        print(f"pack_full: plan {tp1-tp0:.2f}s alloc {tp2-tp1:.2f}s "
              f"emit {time.perf_counter()-tp2:.2f}s", file=sys.stderr)
    return dict(vals=vals, idxT=idxT, tile_block=t_block, tile_part=t_part,
                tile_first=t_first, tile_last=t_last, class_map=cmap,
                leftover=leftover, nnz=nnz - nleft,
                opt_waves=int(opt_waves.value))
