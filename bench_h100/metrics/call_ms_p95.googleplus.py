"""The p95 call time in the googleplus call cells."""
from bench_h100.readers import call_ms_p95 as read  # noqa: F401
