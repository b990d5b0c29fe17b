"""Tracing / observability: phase logs and the device profiler.

The port of ``hisparse_tpu/utils/tracing.py`` (the analog of the
reference's INFO phase logs, sw/host.cpp:146,232,300,358, and its OpenCL
queue profiling, :589):

  * phase logging with timestamps (``log_phase`` / ``phase`` context),
    toggled by HISPARSE_LOG;
  * ``device_profile(logdir)``, a ``torch.profiler`` capture of CPU and
    CUDA activity (the ``jax.profiler`` trace's counterpart) that writes a
    Chrome trace into ``logdir``.
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


@contextlib.contextmanager
def device_profile(logdir: str, device="cuda"):
    """Profile the block's CPU and CUDA activity (CPU alone for
    ``device="cpu"``) and, on exit, write it as a Chrome trace to
    ``logdir/hisparse.<pid>.<ns>.pt.trace.json``, also when the block
    raises.  Yields the ``torch.profiler.profile``; its ``trace_path``
    attribute names the file once the block has ended.  A CUDA device that is not there
    raises: the CPU trace is only for a caller that asks for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_profile needs a CUDA device")
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        activities = [ProfilerActivity.CPU]
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.trace_path = os.path.join(
            logdir, f"hisparse.{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(prof.trace_path)
