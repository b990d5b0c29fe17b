"""Operations a second in the masked SSSP cell (host-bound: the tile selection and frontier read set them)."""
from bench_h100.readers import gops as read  # noqa: F401
