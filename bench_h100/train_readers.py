"""The readers of the training cell's metrics (``drivers/train.py``): each
takes the run's record and returns one number, or None where the record
holds nothing for it (another driver's run, or a program without the
GCN's spans).  ``metrics/<metric>.py`` names them."""
from __future__ import annotations

from bench_h100 import readers, spans
from bench_h100.gen import stats

# the spans of the GCN's aggregations, forward and backward
AGG = ("hisparse.gcn.agg", "hisparse.gcn.agg_grad")


def _train(rec) -> bool:
    return rec.get("driver") == "train"


def agg_pct(rec):
    """The share of the device's busy time, in percent, launched under the
    aggregations' spans, forward and backward."""
    if not _train(rec):
        return None
    return spans.attributed_pct(rec, AGG)


def spmm_roofline(rec):
    """The least time the card could take for the traced steps' products
    of ``Â`` (``bound_s``: the CSR work at each width, ``gen/train_work``)
    over the device time launched under the aggregations' spans (their
    union), in percent."""
    if not _train(rec) or not rec.get("spans") or "bound_s" not in rec:
        return None
    sp, hi = rec["spans"], rec["window_s"] * 1e6
    t = stats.covered([(s, e) for s, e, _, ch in rec["device_spans"]
                       if any(sp[i][2] in AGG for i in ch)], 0.0, hi)
    if t <= 0:
        return None
    return 100.0 * rec["bound_s"] / (t * 1e-6)


def mfu(rec):
    """The traced steps' model operations (``flops_step``, a counter) over
    the traced stretch's wall seconds times the card's fp32 peak outside
    the tensor cores (``gen/work.py``), in percent: the whole step's share
    of the peak."""
    peak = rec["counters"].get("fp32_peak_ops_per_s")
    flops = rec["counters"].get("flops_step")
    if not _train(rec) or not peak or not flops or not rec.get("busy_s"):
        return None
    return 100.0 * flops * rec["requests"] / (rec["window_s"] * peak)


# the share of the traced stretch in which the device runs nothing:
# 1 - the union of its activity over the stretch's wall time
idle_pct = readers._idle_pct("train")
