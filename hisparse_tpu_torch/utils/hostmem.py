"""Host allocator tuning for pack throughput: the port's copy of
``hisparse_tpu/utils/hostmem.py`` (ctypes and numpy only).

Packing (``formats/wavepack.py``, ``formats/_scheduler.cpp``) makes
several O(nnz) numpy passes, so on a host where page faults are dear its
time goes to first-touching fresh memory:

1. numpy madvises ``MADV_HUGEPAGE`` on every large allocation (its Linux
   default).  With transparent hugepages in ``madvise`` mode a host may
   compact synchronously on each fault.
2. glibc serves every large numpy temporary by a fresh mmap and returns it
   on free, so each pass faults its hundreds of MB anew.
3. numpy's madvise flag does not cover every THP path; ``prctl(
   PR_SET_THP_DISABLE)`` opts the whole process out.

``tune_allocator()`` disables numpy's hugepage madvise, disables THP for
the whole process through prctl, and raises the glibc mmap and trim
thresholds so that large allocations come from the (persistent, already
faulted) heap and its high-water mark is reused across passes and packs.
The JAX package calls it at import, for the virtualised TPU host it was
measured on.  The port does not: on the H100's host the googleplus pack
timed in fresh processes, tuned against untuned
(``python -m hisparse_tpu_torch.utils.hostmem_ab``; PERF.md), did not
show the tuned pack faster.  A caller whose host faults slowly may call
it.  Idempotent; each knob is a no-op where it is not available.  The
settings are process-wide.
"""
from __future__ import annotations

import ctypes

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_PR_SET_THP_DISABLE = 41
# allocations below it come from the heap, which is never trimmed below
# it: the largest C int mallopt takes (the JAX copy passes 2^31, which
# ctypes wraps to a negative int)
_THRESHOLD = 2**31 - 1


def _disable_numpy_hugepages() -> bool:
    try:
        try:
            from numpy._core import multiarray as _ma  # numpy >= 2
        except ImportError:  # pragma: no cover - numpy 1.x
            from numpy.core import multiarray as _ma  # type: ignore
        _ma._set_madvise_hugepage(False)
        return True
    except (ImportError, AttributeError):  # pragma: no cover - API moved
        return False


def tune_allocator() -> bool:
    """Serve allocations below 2 GiB from the persistent heap, never trim
    it back, and stop numpy from requesting hugepages.  Returns True if
    the glibc mallopt calls succeeded."""
    global _done
    if _done:
        return True
    _disable_numpy_hugepages()
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
        libc.prctl.restype = ctypes.c_int
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt.restype = ctypes.c_int
        libc.prctl(_PR_SET_THP_DISABLE, 1, 0, 0, 0)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, _THRESHOLD) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, _THRESHOLD) == 1)
    except (OSError, AttributeError):
        return False
    _done = ok
    return ok

