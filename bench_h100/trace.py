"""What the traced run reads from ``torch.profiler``: the device's activity
(kernels, copies, sets) inside the traced window, its union, the device
operations that took most time and the longest idle gaps, each labelled by
the innermost host operation running at its middle; and the program's
``hisparse.*`` spans with the device work launched under each
(``spans.py``)."""
from __future__ import annotations

import bisect
import collections

import torch

from bench_h100.gen import stats

WINDOW = "bench.window"
REQUEST = "bench.request"
TOP = 10
# host events searched back from a gap's middle for one that covers it
LOOK_BACK = 512


def read(prof) -> dict:
    """:func:`device_work` of the profile's events, with ``spans`` and
    ``device_spans`` (``spans.read``)."""
    from bench_h100 import spans     # spans.py imports this module
    rec = device_work(prof.events())
    rec.update(spans.read(prof))
    return rec


def device_work(events) -> dict:
    """``window_s``, ``busy_s``, ``device`` (the device intervals inside the
    window, as ``(start_us, end_us, name)``) and ``breakdown``, from the
    profiler's ``events()``."""
    dev, host, window = [], [], None
    for e in events:
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's mirror on the device timeline is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                dev.append(iv)
        elif e.name == WINDOW:
            window = iv
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi = window[0], window[1]
    dev = [d for d in dev if d[1] > lo and d[0] < hi]
    busy = stats.covered(dev, lo, hi)
    by_op = collections.Counter()
    for s, e, name in dev:
        by_op[name] += (min(e, hi) - max(s, lo)) * 1e-6
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "device": dev,
            "breakdown": {
                "device_ops": [[n, s] for n, s in by_op.most_common(TOP)],
                "idle_gaps": idle_gaps(dev, host, lo, hi)}}


def idle_gaps(dev, host, lo: float, hi: float) -> list:
    """Idle seconds of the device inside ``[lo, hi]``, summed by the
    innermost host event covering each gap's middle, largest first."""
    host = sorted(host)
    starts = [h[0] for h in host]
    by_label = collections.Counter()
    for s, e in stats.gaps(dev, lo, hi):
        mid = (s + e) / 2
        label = "host (no traced op)"
        k = bisect.bisect_right(starts, mid)
        for j in range(k - 1, max(k - 1 - LOOK_BACK, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by_label[label] += (e - s) * 1e-6
    return [[n, s] for n, s in by_label.most_common(TOP)]
