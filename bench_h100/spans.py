"""The program's spans in a traced run, on the profiler's clock, and the
per-layer quantities read from them.

The port marks its phases with ``hisparse.*`` spans
(``hisparse_tpu_torch/utils/tracing.span``), which are
``record_function``s while a profiler runs.  :func:`read` turns the
profiler's events into two things, each time in microseconds from the
start of the traced window (``trace.WINDOW``):

  * ``spans``: the program's host spans, ``(start, end, name, thread,
    parent)``, in order of start; ``parent`` is the index of the innermost
    span that encloses it on its thread, -1 at the top;
  * ``device_spans``: each device interval inside the window that
    ``trace.read`` counts as device work, ``(start, end, name, chain)``;
    ``chain`` is the indices of the spans that were open on the host when
    it was launched, innermost first (empty when none was).

A device interval is placed by its launch.  Its ``linked_correlation_id``
names the torch op that launched it (torch's own ``device_corr_map``); a
kernel launched through ``ctypes`` (``ops/_kernels.py``) has no torch op
and no link, and its own correlation id names its runtime call
(``cudaLaunchKernel`` and kin), which serves in its place.  The launching
event's start, on its thread, lies inside the spans of the chain.

``trace.read`` adds both to the traced run's record, and the readers
below are metrics of ``BENCHMARK.json`` (``metrics/<name>.py``).  With
``--workload`` this module runs a cell as ``run.py --trace 1`` does and
prints every reader's value, and the share of busy time each span tree
accounts for, beside the result line:

    python3 -m bench_h100.spans --workload googleplus-spmv --seed 7
"""
from __future__ import annotations

import bisect
import collections
import statistics

from bench_h100.gen import stats
from bench_h100.trace import WINDOW

PREFIX = "hisparse."
CALLS = ("hisparse.forward", "hisparse.matmul", "hisparse.masked")
# Event: one profiler event, host or device; ``corr`` its correlation id,
# ``link`` the correlation id of the host op that launched it (device
# events and runtime calls; 0 where there is none)
Event = collections.namedtuple(
    "Event", "name device corr link thread start end annotation")


def events(prof) -> list:
    """The profiler's events as :class:`Event`s, in microseconds from the
    trace's start (the clock of ``prof.events()``)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [Event(e.name(), e.device_type().name != "CPU",
                  e.correlation_id(), e.linked_correlation_id(),
                  e.start_thread_id(), (e.start_ns() - t0) / 1e3,
                  (e.end_ns() - t0) / 1e3, bool(e.is_user_annotation()))
            for e in res.events()]


def read(prof) -> dict:
    """``spans`` and ``device_spans`` of the traced window (module doc)."""
    return attribute(events(prof))


def _is_runtime(e: Event) -> bool:
    # the CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
    # cudaMemcpyAsync, ...): their correlation ids are CUPTI's, a number
    # space apart from the torch ops'
    return not e.device and not e.annotation and e.name.startswith("cu")


def attribute(evs) -> dict:
    """:func:`read` on a list of :class:`Event`s."""
    window = [e for e in evs if not e.device and e.name == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window span")
    lo, hi = window[0].start, window[0].end
    host = [e for e in evs if not e.device]
    ops = {e.corr: e for e in host if not _is_runtime(e)}
    runtime = {e.corr: e for e in host if _is_runtime(e)}

    # the spans, nested by time a thread
    raw = sorted((e for e in host if e.name.startswith(PREFIX)
                  and e.end > lo and e.start < hi),
                 key=lambda e: (e.start, -e.end))
    spans, by_thread, open_ = [], collections.defaultdict(list), {}
    for e in raw:
        start = e.start - lo
        stack = open_.setdefault(e.thread, [])
        while stack and spans[stack[-1]][1] <= start:
            stack.pop()
        spans.append((start, e.end - lo, e.name, e.thread,
                      stack[-1] if stack else -1))
        by_thread[e.thread].append(len(spans) - 1)
        stack.append(len(spans) - 1)
    starts = {t: [spans[i][0] for i in ix] for t, ix in by_thread.items()}

    def chain(t: float, thread) -> list:
        """The spans open on ``thread`` at ``t``, innermost first."""
        ix = by_thread.get(thread, [])
        k = bisect.bisect_right(starts.get(thread, []), t) - 1
        # the last span to start at or before t, or the nearest ancestor
        # of it that is still open at t
        i = ix[k] if k >= 0 else -1
        while i >= 0 and spans[i][1] < t:
            i = spans[i][4]
        out = []
        while i >= 0:
            out.append(i)
            i = spans[i][4]
        return out

    device = []
    for e in evs:
        # trace.read's device work: no span's mirror
        if (not e.device or e.annotation or e.name.startswith("bench.")
                or e.end <= lo or e.start >= hi):
            continue
        launch = ops.get(e.link) if e.link else None
        if launch is None:
            launch = runtime.get(e.corr)
        device.append((e.start - lo, e.end - lo, e.name,
                       [] if launch is None
                       else chain(launch.start - lo, launch.thread)))
    device.sort(key=lambda d: d[0])
    return {"spans": spans, "device_spans": device}


# --- the readers: each takes the run's record and returns one number, or
# None where the record holds no spans (a program without them)


def _has(rec) -> bool:
    return bool(rec.get("spans"))


def _device_us_under(rec, names) -> float:
    """Device microseconds inside the window of the intervals launched
    under a span named one of ``names``."""
    spans, hi = rec["spans"], rec["window_s"] * 1e6
    return sum(min(e, hi) - max(s, 0.0)
               for s, e, _, ch in rec["device_spans"]
               if any(spans[i][2] in names for i in ch))


def _per_request_us(name):
    def read(rec):
        if rec["driver"] != "calls" or not _has(rec):
            return None
        return _device_us_under(rec, (name,)) / rec["requests"]
    return read


# device microseconds a traced call in the x loader (x to XT: the
# column gather and build_xt / build_xt_multi)
xt_us = _per_request_us("hisparse.x")
# device microseconds a traced call in the operator's stripe folds
stripe_fold_us = _per_request_us("hisparse.stripe_fold")


def combine_ms(rec):
    """Device milliseconds a traced query in the fold of the app's renamed
    y into rank order (``hisparse.combine``, ``_App._fold``)."""
    if rec["driver"] != "queries" or not _has(rec):
        return None
    return _device_us_under(rec, ("hisparse.combine",)) / rec[
        "requests"] / 1e3


def host_ms_iter(rec):
    """The median over traced app iterations of the host's time in
    ``hisparse.step`` less its ``hisparse.sync`` children (the host read
    that waits for the device): the host's own enqueue work an iteration,
    in milliseconds."""
    if rec["driver"] != "queries" or not _has(rec):
        return None
    spans = rec["spans"]
    own = {i: s[1] - s[0] for i, s in enumerate(spans)
           if s[2] == "hisparse.step"}
    for s in spans:
        if s[2] == "hisparse.sync" and s[4] in own:
            own[s[4]] -= s[1] - s[0]
    if not own:
        return None
    return statistics.median(own.values()) / 1e3


def program_idle_pct(rec):
    """The share of the traced window, in percent, in which the device is
    idle while the host is inside an operator call span (``CALLS``): the
    intersection of the device's gaps with the union of the call spans.
    The rest of the window's idle is the harness's loop and synchronize."""
    if rec["driver"] != "calls" or not _has(rec):
        return None
    hi = rec["window_s"] * 1e6
    gaps = stats.gaps([(s, e) for s, e, _, _ in rec["device_spans"]],
                      0.0, hi)
    calls = stats.union([(s, e) for s, e, n, _, _ in rec["spans"]
                         if n in CALLS], 0.0, hi)
    return 100.0 * overlap(gaps, calls) / hi


def attributed_pct(rec, names) -> float | None:
    """The share of the device's busy time, in percent, launched under a
    span named one of ``names``."""
    if not _has(rec):
        return None
    hi = rec["window_s"] * 1e6
    busy = stats.covered([(s, e) for s, e, _, _ in rec["device_spans"]],
                         0.0, hi)
    spans = rec["spans"]
    mine = stats.covered([(s, e) for s, e, _, ch in rec["device_spans"]
                          if any(spans[i][2] in names for i in ch)],
                         0.0, hi)
    return 100.0 * mine / busy if busy else None


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


READERS = {"xt_us": xt_us, "stripe_fold_us": stripe_fold_us,
           "combine_ms.query": combine_ms, "host_ms.iter": host_ms_iter,
           "program_idle_pct.call": program_idle_pct}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import harness, trace
    if not torch.cuda.is_available():
        print("spans.py needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.Spec(args.workload, harness.load_json(
        os.path.join(root, "BENCHMARK.json")))
    kept = {}
    read_trace = trace.read

    def keep(prof):
        kept["rec"] = read_trace(prof)
        return kept["rec"]

    trace.read = keep
    try:
        line = harness.run_cell(spec, args.seed, 0.0, True, "cuda:0")
    finally:
        trace.read = read_trace
    rec = kept["rec"]
    line["spans"] = {name: fn(rec) for name, fn in READERS.items()}
    line["spans"]["attributed_pct"] = {
        "calls": attributed_pct(rec, CALLS),
        "step": attributed_pct(rec, ("hisparse.step",))}
    line["spans"]["n_spans"] = len(rec["spans"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
