"""The share of device busy time under the GCN's aggregation spans, forward and
backward (hisparse.gcn.agg, hisparse.gcn.agg_grad)."""
from bench_h100.train_readers import agg_pct as read  # noqa: F401
