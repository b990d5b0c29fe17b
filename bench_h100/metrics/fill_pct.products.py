"""The shared pack's fill in the ogbn-products cell."""
from bench_h100.readers import fill_pct as read  # noqa: F401
