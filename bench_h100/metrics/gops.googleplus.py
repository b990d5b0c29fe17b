"""Operations a second in the googleplus cells (host-bound: the enqueue's speed sets them)."""
from bench_h100.readers import gops as read  # noqa: F401
