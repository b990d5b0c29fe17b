"""The device's idle share over traced training steps."""
from bench_h100.train_readers import idle_pct as read  # noqa: F401
