"""Device us a call in row_fold, googleplus cells."""
from bench_h100.readers import fold_us as read  # noqa: F401
