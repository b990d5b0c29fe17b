"""The p95 query time in the masked SSSP cell."""
from bench_h100.readers import query_ms_p95 as read  # noqa: F401
