"""The device's idle share over traced masked queries."""
from bench_h100.readers import idle_pct_query as read  # noqa: F401
