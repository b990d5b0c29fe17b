"""Device us a call in the x loader (hisparse.x), googleplus cells."""
from bench_h100.spans import xt_us as read  # noqa: F401
