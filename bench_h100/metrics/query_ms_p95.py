"""The p95 query time in the query cells."""
from bench_h100.readers import query_ms_p95 as read  # noqa: F401
