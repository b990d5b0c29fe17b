"""The host's own time an iteration of a masked query, from the program's spans."""
from bench_h100.spans import host_ms_iter as read  # noqa: F401
