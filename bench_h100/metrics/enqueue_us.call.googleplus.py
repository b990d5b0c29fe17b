"""The host's enqueue of a call, googleplus cells."""
from bench_h100.readers import enqueue_us as read  # noqa: F401
