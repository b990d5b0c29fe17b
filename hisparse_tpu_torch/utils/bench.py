"""Device timing on CUDA events, and the reference's rate definitions.

``device_time_ms`` replaces ``hisparse_tpu/utils/bench.device_loop_time``
for the port: each timed call sits between its own pair of CUDA events on
the current stream, after warm-up calls, and the median is returned.  It
needs a CUDA device and raises without one; a CPU run has no device time.

GOPS = 2*nnz/t and stream GB/s = stream_bytes/t are the reference's
definitions (sw/benchmark.cpp:312-314, quoted in BASELINE.md).

Also the parity families that the tests and ``chip_smoke.py`` run the
port on.
"""
from __future__ import annotations

import statistics
from typing import Callable

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import powerlaw_csr
from ..formats.wavepack import pack

# The config families of the JAX package's chip parity sweep
# (scripts/tpu_check.py:49-86): (name, SpmvConfig fields, columns beyond
# one partition, the JAX operator variant).  Family i packs
# powerlaw_csr(2000, vb_cols + extra, 9, alpha=1.2, seed=40 + i) with
# split_max=16; its x is default_rng(100 + i).random(num_cols).
PARITY_FAMILIES = (
    ("chain-fp32", dict(sublanes=256, bank_blocks=2, stripes=128,
                        two_choice=True), 0, "auto"),
    ("chain-steal-mxu", dict(sublanes=256, bank_blocks=2, stripes=128,
                             two_choice=True, steal_mantissa=True),
     0, "auto"),
    ("chain-steal-idx16", dict(sublanes=256, bank_blocks=2, stripes=128,
                               two_choice=True, steal_mantissa=True,
                               idx16=True), 0, "auto"),
    ("bm-k2-steal", dict(sublanes=256, bank_blocks=8, stripes=128,
                         two_choice=False, block_major=True,
                         classes_per_group=2, steal_mantissa=True),
     0, "auto"),
    ("bm-k4-tc", dict(sublanes=256, bank_blocks=4, stripes=128,
                      two_choice=True, block_major=True,
                      classes_per_group=4, steal_mantissa=True), 0, "auto"),
    ("bm-k2-idx16", dict(sublanes=256, bank_blocks=8, stripes=128,
                         two_choice=False, block_major=True,
                         classes_per_group=2, steal_mantissa=True,
                         idx16=True), 0, "auto"),
    ("fixed-q8.24", dict(sublanes=128, bank_blocks=2, stripes=64,
                         dtype="fixed", two_choice=False), 0, "auto"),
    ("bf16-stream", dict(sublanes=128, bank_blocks=2, stripes=64,
                         dtype="bf16"), 0, "auto"),
    ("min-plus", dict(sublanes=128, bank_blocks=2, stripes=64,
                      semiring="min_plus", two_choice=False), 0, "auto"),
    ("max-times", dict(sublanes=128, bank_blocks=2, stripes=64,
                       semiring="max_times", two_choice=False), 0, "auto"),
    ("paged-multipart", dict(sublanes=128, bank_blocks=1, stripes=128,
                             two_choice=False), 3 * 128 * 128, "paged"),
    ("paged-bm", dict(sublanes=256, bank_blocks=2, stripes=128,
                      two_choice=False, block_major=True,
                      classes_per_group=2, steal_mantissa=True),
     2 * 2 * 128 * 128, "paged"),
)

FAMILY_INDEX = {f[0]: i for i, f in enumerate(PARITY_FAMILIES)}

# the families this slice runs: fp32 plus_times
FP32_FAMILIES = tuple(
    f for f in PARITY_FAMILIES
    if f[1].get("dtype", "fp32") == "fp32"
    and f[1].get("semiring", "plus_times") == "plus_times")

# every parity family fits one row block; this one spans two (stripes=32
# makes a row block 4096 rows)
MULTIBLOCK_FAMILY = ("chain-multiblock",
                     dict(sublanes=256, bank_blocks=2, stripes=32),
                     None, "auto")


def family_inputs(fam):
    """``(powerlaw_csr args, split_max, x seed)`` of a family's matrix."""
    name, kw, extra, _ = fam
    cfg = SpmvConfig(**kw)
    if name == MULTIBLOCK_FAMILY[0]:
        return (2 * cfg.rows_per_block - 10, cfg.vb_cols + 17, 4, 1.5,
                6), None, 66
    i = FAMILY_INDEX[name]
    return (2000, cfg.vb_cols + extra, 9, 1.2, 40 + i), 16, 100 + i


def family_case(fam):
    """``(matrix, pack, x)`` of a family, made with this package alone."""
    args, split, xseed = family_inputs(fam)
    m = powerlaw_csr(*args)
    wp = pack(m, SpmvConfig(**fam[1]), split_max=split)
    x = np.random.default_rng(xseed).random(m.num_cols).astype(np.float32)
    return m, wp, x


def device_time_ms(fn: Callable[[], object], reps: int = 20,
                   warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` timed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def gops(nnz: int, ms: float) -> float:
    return 2.0 * nnz / (ms * 1e-3) / 1e9


def gbps(nbytes: int, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9
