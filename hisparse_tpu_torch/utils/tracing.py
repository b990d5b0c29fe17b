"""Phase logging with timestamps, toggled by HISPARSE_LOG.

The ``log_phase`` / ``phase`` half of ``hisparse_tpu/utils/tracing.py``
(the analog of the reference hosts' INFO phase logs,
sw/host.cpp:146,232,300,358).  The device-profiler hook is not ported yet.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time


def log_enabled() -> bool:
    return bool(int(os.environ.get("HISPARSE_LOG", "0")))


def log_phase(msg: str) -> None:
    if log_enabled():
        print(f"[INFO {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log_phase(f"{name} ...")
    t0 = time.perf_counter()
    yield
    log_phase(f"{name} done in {time.perf_counter()-t0:.3f}s")
