"""Tracing / observability: spans, phase logs and the device profiler.

The port of ``hisparse_tpu/utils/tracing.py`` (the analog of the
reference's INFO phase logs, sw/host.cpp:146,232,300,358, and its OpenCL
queue profiling, :589):

  * ``span(name)``, the one timing helper: a ``torch.profiler``
    ``record_function`` while a profiler runs, so that the span sits on the
    profiler's clock beside the device work it launched; a timestamped
    stderr log of its duration under HISPARSE_LOG (``log_phase``; ``phase``
    is the JAX package's name for it); otherwise a shared null context;
  * ``device_profile(logdir)``, a ``torch.profiler`` capture of CPU and
    CUDA activity (the ``jax.profiler`` trace's counterpart) that writes a
    Chrome trace into ``logdir``.

The program's spans are named ``hisparse.*`` and nest by time on the
calling thread: ``hisparse.forward`` / ``matmul`` / ``masked`` around an
operator call, ``hisparse.x`` (x to XT) and ``hisparse.stripe_fold``
inside it; ``hisparse.step`` around an app iteration, ``hisparse.sync``
(its host read) and ``hisparse.combine`` (the fold of hub-split
partials into rank order) inside it;
``hisparse.pack.*`` around the pack's phases.  The GCN
(``models/gnn.py``) adds ``hisparse.gcn.layer`` around each layer's
forward, with ``hisparse.gcn.agg`` (a forward aggregation, its
``hisparse.matmul`` inside) and ``hisparse.gcn.dropout`` in it, and
``hisparse.gcn.agg_grad`` around each backward aggregation.  Autograd runs
a CUDA backward on a thread of its own, which the profiler's state
follows: ``agg_grad`` spans nest by time on that thread.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
# os.environ's own mapping (bytes names on POSIX): a name's membership
# there is one lookup, where os.environ.get raises and catches a KeyError
# for an unset name, about a microsecond of every span on the null path
_ENV = os.environ._data
_LOG_NAME = os.environ.encodekey("HISPARSE_LOG")


def log_enabled() -> bool:
    return bool(int(os.environ.get("HISPARSE_LOG", "0")))


def log_phase(msg: str) -> None:
    if log_enabled():
        print(f"[INFO {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


def span(name: str):
    """A context manager that marks a phase of the program as ``name``.

    While a ``torch.profiler`` runs it is ``record_function(name)``: the
    span is a host event on the profiler's clock, so that the device work
    launched inside it can be put down to it (``bench_h100/spans.py``).
    With HISPARSE_LOG=1 it logs
    ``name ...`` on entry and its duration on exit.  Otherwise it returns
    one shared null context: a flag read and a dict lookup, no allocation
    and no call into the dispatcher."""
    if _profiler._is_profiler_enabled:
        rf = _profiler.record_function(name)
        return _logged(name, rf) if _logging() else rf
    return _logged(name, _NULL) if _logging() else _NULL


phase = span


def _logging() -> bool:
    return _LOG_NAME in _ENV and log_enabled()


@contextlib.contextmanager
def _logged(name: str, inner):
    log_phase(f"{name} ...")
    t0 = time.perf_counter()
    with inner:
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
