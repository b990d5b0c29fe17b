"""Device timing on CUDA events, and the reference's rate definitions.

``device_time_ms`` replaces ``hisparse_tpu/utils/bench.device_loop_time``
for the port: each timed call sits between its own pair of CUDA events on
the current stream, after warm-up calls, and the median is returned;
``queued=True`` keeps the host's enqueue time out of a kernel's time.
``profile_breakdown`` splits a call's device time by op under
``torch.profiler`` and gives its device idle share.  Both need a CUDA
device and raise without one; a CPU run has no device time.

GOPS = 2*nnz/t and stream GB/s = stream_bytes/t are the reference's
definitions (sw/benchmark.cpp:312-314, quoted in BASELINE.md).

Also the parity families that the tests and ``chip_smoke.py`` run the
port on, a float64 oracle for the min_plus and max_times families, and
sparse vectors for the masked call.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable

import numpy as np
import torch

from ..config import SpmvConfig
from ..formats.csr import powerlaw_csr
from ..formats.wavepack import pack
from ..ops.golden import float_to_fixed

# The config families of the JAX package's chip parity sweep
# (scripts/tpu_check.py:49-86): (name, SpmvConfig fields, columns beyond
# one partition, the JAX operator variant).  Family i packs
# powerlaw_csr(2000, vb_cols + extra, 9, alpha=1.2, seed=40 + i) with
# split_max=16; its x is default_rng(100 + i).random(num_cols).  The
# fixed-point family takes both as Q8.24 words, the values scaled by
# 1/(4*9) so that no row sum saturates (scripts/tpu_check.py:93-100).
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

# the plus_times families: every value type (fp32, Q8.24, bf16)
PLUS_TIMES_FAMILIES = tuple(
    f for f in PARITY_FAMILIES
    if f[1].get("semiring", "plus_times") == "plus_times")
# those of them with fp32 values, for the fp32-only gradient stream
FP32_FAMILIES = tuple(f for f in PLUS_TIMES_FAMILIES
                      if f[1].get("dtype", "fp32") == "fp32")

# every parity family fits one row block; this one spans two (stripes=32
# makes a row block 4096 rows)
MULTIBLOCK_FAMILY = ("chain-multiblock",
                     dict(sublanes=256, bank_blocks=2, stripes=32),
                     None, "auto")

# the min_plus and max_times families: the parity sweep's two, and
# chain-fp32 (two_choice select-chain, the graph apps' own config shape) in
# each semiring.  A family named "<base>/<semiring>" packs the matrix of
# family <base> and takes its x.
SEMIRING_FAMILIES = tuple(
    f for f in PARITY_FAMILIES
    if f[1].get("semiring", "plus_times") != "plus_times") + tuple(
    (f"chain-fp32/{sr}", dict(PARITY_FAMILIES[0][1], semiring=sr), 0,
     "auto") for sr in ("min_plus", "max_times"))


def family_inputs(fam):
    """``(powerlaw_csr args, split_max, x seed)`` of a family's matrix."""
    name, kw, extra, _ = fam
    cfg = SpmvConfig(**kw)
    if name == MULTIBLOCK_FAMILY[0]:
        return (2 * cfg.rows_per_block - 10, cfg.vb_cols + 17, 4, 1.5,
                6), None, 66
    i = FAMILY_INDEX[name.split("/")[0]]
    return (2000, cfg.vb_cols + extra, 9, 1.2, 40 + i), 16, 100 + i


def family_case(fam):
    """``(matrix, pack, x)`` of a family, made with this package alone;
    for the fixed-point family the matrix values and x are Q8.24 words
    (uint32)."""
    args, split, xseed = family_inputs(fam)
    m = powerlaw_csr(*args)
    x = np.random.default_rng(xseed).random(m.num_cols)
    if fam[1].get("dtype") == "fixed":
        m = dataclasses.replace(m, data=float_to_fixed(
            np.abs(m.data) / (4 * 9)))
        x = float_to_fixed(x)
    else:
        x = x.astype(np.float32)
    wp = pack(m, SpmvConfig(**fam[1]), split_max=split)
    return m, wp, x


def semiring_f64(m, x, semiring: str) -> np.ndarray:
    """Float64 oracle of ``y = A (x) x`` in natural row order: the row sum
    of v*x (plus_times), the least v + x (min_plus; +inf for a row without
    entries) or the greatest v*x clamped at 0 (max_times; 0 for a row
    without entries, the port's and the JAX package's convention)."""
    rows = np.repeat(np.arange(m.num_rows), m.row_nnz())
    v = np.asarray(m.data, np.float64)
    xc = np.asarray(x, np.float64)[m.indices]
    if semiring == "plus_times":
        out = np.zeros(m.num_rows)
        np.add.at(out, rows, v * xc)
    elif semiring == "min_plus":
        out = np.full(m.num_rows, np.inf)
        np.minimum.at(out, rows, v + xc)
    else:
        out = np.full(m.num_rows, -np.inf)
        np.maximum.at(out, rows, v * xc)
        out = np.maximum(out, 0.0)
    return out


def sparse_x(num_cols: int, k: int, semiring: str, seed: int = 0):
    """``(x, active)``: float32 x holding the semiring's multiplicative
    annihilator (+inf for min_plus, else 0) outside ``k`` random active
    columns, which hold U(0.5, 1.5); ``active`` their sorted ids."""
    rng = np.random.default_rng(seed)
    active = np.sort(rng.choice(num_cols, k, replace=False))
    x = np.full(num_cols, np.inf if semiring == "min_plus" else 0.0,
                np.float32)
    x[active] = rng.random(k) + 0.5
    return x, active


def device_time_ms(fn: Callable[[], object], reps: int = 20,
                   warmup: int = 3, queued: bool = False) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` timed calls.

    By default each pair of events also takes in any time the device
    waits for the host to enqueue ``fn``'s work, which a caller of a whole
    forward or training step waits for too.  ``queued=True`` times the
    device work alone, for one kernel launch whose host enqueue (operand
    checks, ctypes) may outlast it: a device sleep holds the stream while
    the host enqueues every timed call.  ``fn`` must not synchronise
    then; a hold that ends before the last call is enqueued raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        # about 1 ms a call at the H100's 1.98 GHz boost clock
        torch.cuda._sleep(2_000_000 * (reps + 1))
        held = torch.cuda.Event()
        held.record()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    if queued and held.query():
        raise RuntimeError("device_time_ms: the device ran dry before the "
                           "last timed call was enqueued")
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profile_breakdown(fn: Callable[[], object], steps: int = 10,
                      warmup: int = 3) -> dict:
    """Where the device time of ``fn()`` goes.

    ``ms`` is ``fn``'s event-timed median without the profiler
    (:func:`device_time_ms`).  Then ``torch.profiler`` traces ``steps``
    back-to-back calls; every device activity (kernel, memcpy, memset) is
    summed by name.  Returns ``ms``, ``busy_us`` (device µs per call),
    ``idle_share`` = 1 - busy / ms, the share of the unprofiled call in
    which the device runs nothing, and ``ops``: ``(µs per call, launches
    per call, name)`` rows, largest first.  Raises if the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    ms = device_time_ms(fn, reps=steps, warmup=warmup)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in by_name.values()) / steps
    if busy <= 0.0:
        raise RuntimeError("profile_breakdown: the trace holds no device "
                           "time")
    ops = sorted(((us / steps, n / steps, name)
                  for name, (us, n) in by_name.items()), reverse=True)
    return {"ms": ms, "busy_us": busy,
            "idle_share": max(0.0, 1.0 - busy / (ms * 1e3)), "ops": ops}


def geomean(vals) -> float:
    vals = [v for v in vals if v > 0]
    return float(np.exp(np.mean(np.log(vals)))) if vals else 0.0


def gops(nnz: int, ms: float) -> float:
    return 2.0 * nnz / (ms * 1e-3) / 1e9


def gbps(nbytes: int, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9
