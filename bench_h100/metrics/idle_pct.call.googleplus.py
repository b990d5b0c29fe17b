"""The device's idle share over traced calls, googleplus cells."""
from bench_h100.readers import idle_pct_call as read  # noqa: F401
