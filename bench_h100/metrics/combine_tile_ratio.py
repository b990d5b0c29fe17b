"""Combine tiles over main tiles of the app's packs."""
from bench_h100.readers import combine_tile_ratio as read  # noqa: F401
