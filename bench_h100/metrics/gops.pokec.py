"""Operations a second in the pokec cells (device-bound)."""
from bench_h100.readers import gops as read  # noqa: F401
