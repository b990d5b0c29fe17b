"""The whole set-up, script start to the first timed call."""
from bench_h100.readers import setup_s as read  # noqa: F401
