"""The share of the dense stream a masked query reads, in tiles."""
from bench_h100.readers import tile_pct as read  # noqa: F401
