"""The host seconds from the CSR matrix to an operator or app on the card."""
from bench_h100.readers import prepare_s as read  # noqa: F401
