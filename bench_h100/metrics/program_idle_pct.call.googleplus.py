"""The device idle while the host is inside a call span, googleplus cells."""
from bench_h100.spans import program_idle_pct as read  # noqa: F401
