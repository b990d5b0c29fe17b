"""The requests' share of the CSR work's roofline, pokec cells."""
from bench_h100.readers import request_roofline as read  # noqa: F401
