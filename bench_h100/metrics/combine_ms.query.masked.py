"""Device ms a masked query in the fold into rank order (hisparse.combine)."""
from bench_h100.spans import combine_ms as read  # noqa: F401
