"""The streamed pack's fill in the googleplus cells."""
from bench_h100.readers import fill_pct as read  # noqa: F401
