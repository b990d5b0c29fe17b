"""The whole training step's share of the fp32 peak."""
from bench_h100.train_readers import mfu as read  # noqa: F401
