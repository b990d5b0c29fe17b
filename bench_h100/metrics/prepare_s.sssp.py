"""The SSSP cells' prepare, host seconds from the CSR matrix to the app on
the card (transpose, pack, plans, upload), read in traced runs too: the
host's speed spreads it too widely for an end-to-end bound here."""
from bench_h100.readers import prepare_s as read  # noqa: F401
