"""The readers of the metrics: each takes the run's record and returns one
number, or None where the record holds nothing for it (the metric is then
left out of the line).  A file ``metrics/<metric>.py`` names the reader of
each metric in ``BENCHMARK.json``; one quantity measured in cells of
different noise is one reader under several names (``gops.googleplus``,
``gops.pokec``), each name with its own cells and bound."""
from __future__ import annotations

import statistics

from bench_h100.gen.stats import p95


def gops(rec):
    """Useful sparse operations completed in the window, over its wall
    seconds (host clock), in 10^9 a second: 2 nnz F a product, 2 nnz an
    SSSP iteration, nnz of the CSR matrix (never the pack's slots)."""
    if "ops" not in rec:
        return None
    return rec["ops"] / rec["window_s"] / 1e9


def _p95_ms(driver):
    def read(rec):
        if rec["driver"] != driver or "durations_s" not in rec:
            return None
        return p95(rec["durations_s"]) * 1e3
    return read


# the 95th percentile of every request in the window, each timed from the
# call into the program to the synchronize after it by two CUDA events on
# the device's clock (``drivers/calls.Stopwatch``)
call_ms_p95 = _p95_ms("calls")
query_ms_p95 = _p95_ms("queries")


def prepare_s(rec):
    """Host seconds from the CSR matrix in host memory to an operator (or
    app) ready on the card: pack, plans and upload, synchronized."""
    return rec.get("prepare_s")


def setup_s(rec):
    """The whole set-up: from the start of the run's script to the first
    timed call (imports, kernel builds, generation, prepare, warm-up)."""
    return rec.get("setup_s")


def fill_pct(rec):
    """Useful slots over all slots of the pack the entry streams
    (``Wavepack.fill``, a program counter), in percent."""
    fill = rec["counters"].get("fill")
    return None if fill is None else 100.0 * fill


def tile_pct(rec):
    """The tiles the masked queries streamed (``SSSP.tiles_streamed``, a
    program counter, the third item of a masked query's key) over their
    iterations times the pack's tiles, in percent: the share of the
    dense stream that the frontier's tile selection reads."""
    keys = [k for k in rec.get("keys", ()) if len(k) > 2]
    tiles = rec["counters"].get("main_tiles")
    if not keys or not tiles:
        return None
    return 100.0 * sum(k[2] for k in keys) / (sum(k[1] for k in keys)
                                              * tiles)


def request_roofline(rec):
    """The least time the card could take for the traced requests (the
    larger of the CSR matrix's bytes at the data sheet's HBM rate and its
    operations at the fp32 rate, ``gen/work.py``), over the device's busy
    time for them (the union of every kernel, copy and set in the trace),
    in percent."""
    if not rec.get("busy_s") or "bound_s" not in rec:
        return None
    return 100.0 * rec["bound_s"] / rec["busy_s"]


def fold_us(rec):
    """Device microseconds a traced request spends in the renamed ->
    natural fold (kernels named ``row_fold``)."""
    t = sum(e - s for s, e, name in rec.get("device", ())
            if "row_fold" in name)
    if t <= 0:
        return None
    return t / rec["requests"]


def enqueue_us(rec):
    """The median of the harness's span (host clock) around each traced
    call, from entering ``forward`` or ``matmul`` to its return, before the
    synchronize: the host's enqueue of the call, in microseconds."""
    if rec["driver"] != "calls" or not rec.get("enqueue_s"):
        return None
    return statistics.median(rec["enqueue_s"]) * 1e6


def _idle_pct(driver):
    def read(rec):
        if rec["driver"] != driver or not rec.get("busy_s"):
            return None
        return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
    return read


# the share of the traced stretch in which the device runs nothing:
# 1 - the union of its activity over the stretch's wall time
idle_pct_call = _idle_pct("calls")
idle_pct_query = _idle_pct("queries")
