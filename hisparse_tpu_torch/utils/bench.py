"""Device timing on CUDA events, and the reference's rate definitions.

``device_time_ms`` replaces ``hisparse_tpu/utils/bench.device_loop_time``
for the port: each timed call sits between its own pair of CUDA events on
the current stream, after warm-up calls, and the median is returned;
``queued=True`` keeps the host's enqueue time out of a kernel's time.
``profile_breakdown`` splits a call's device time by op under
``torch.profiler`` and gives its device idle share.  ``measure_spmv``
gives the reference's benchmark row (``SpmvMetrics``) for one SpMV
operator or a ``HybridSpmv``, against the card's data-sheet HBM rate
(``device_hbm_gbps``) and its measured read rate
(``measured_peak_gbps``).  All of them need a CUDA device and raise
without one; a CPU run has no device time.

GOPS = 2*nnz/t, GBPS = 8*nnz/t and stream GB/s = stream_bytes/t are the
reference's definitions (sw/benchmark.cpp:312-314, quoted in BASELINE.md).

Also the parity families that the tests and ``chip_smoke.py`` run the
port on, a float64 oracle for the min_plus and max_times families, sparse
vectors for the masked call, the fold's hand-made edge plan
(``fold_edge_plan`` / ``fold_edge_values``), and the full-size design
points that ``chip_smoke.py`` and the A/B tools (``parent_ab``,
``ring_sweep``, ``hostmem_ab``) share.
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


# The full-size design points: the suite's googleplus stand-in at its
# tuned point (bench.py:519, bench_tuned.json) and the GCN's widths on it;
# the app rows' 100k power-law graph (bench.py:747) and pokec-shape R-MAT
# stand-in (bench.py:736-800); the transformer-70 training matrix
# (bench.py:819-824) and bcsr-spmm-16k with its right-hand sides
# (bench.py:897-921).
GOOGLEPLUS = dict(shape=(108000, 108000, 127.0, 1.2), seed=11)
GOOGLEPLUS_CFG = dict(sublanes=512, bank_blocks=8, stripes=512,
                      block_major=True, classes_per_group=2,
                      steal_mantissa=True, idx16=True, two_choice=False)
GOOGLEPLUS_PACK = dict(split_max=64, col_order="degree", bm_win=1, bm_adv=1)
GCN_DIMS = (64, 16, 8)
APPS_100K = dict(shape=(100000, 100000, 10), alpha=1.3, seed=2)
POKEC = dict(shape=(1632000, 1632000, 19), seed=6)
T70 = dict(shape=(512, 33288, int(33288 * 0.30)), seed=70)
T70_CFG = dict(sublanes=512, bank_blocks=1, stripes=4, steal_mantissa=True,
               idx16=True, two_choice=False)
BCSR16K = dict(shape=(16384, 16384), block_rows=24, seed=7)
BCSR_RHS = 64


# natural rows of the fold's edge plan, by partials: hub rows of 70 and
# 1,100 partials (the latter over several stages of a hub warp's ring),
# rows of 33 and 32 (one more than the thread path takes, and its most:
# ops/spmv.FOLD_THREAD_MAX), a hub row of 129, a short row, an empty one,
# and rows of one or two
FOLD_EDGE_COUNTS = (70, 33, 32, 5, 0, 129, 1, 2, 1, 1100)
FOLD_EDGE_NANS = (0x7FC00001, 0xFFC00123)    # two NaN payloads, in order


def fold_edge_plan(seed: int = 0):
    """A renamed space holding ``FOLD_EDGE_COUNTS``'s partials and 9
    padding rows in a shuffled order: (perm, num_rows), as a pack's."""
    rows = np.repeat(np.arange(len(FOLD_EDGE_COUNTS)), FOLD_EDGE_COUNTS)
    perm = np.r_[rows, np.full(9, len(FOLD_EDGE_COUNTS))]
    return (np.random.default_rng(seed).permutation(perm),
            len(FOLD_EDGE_COUNTS))


def fold_edge_values(alg: str, perm, n_feat: int = 1, seed: int = 1):
    """(n_renamed, n_feat) partials on ``fold_edge_plan``'s perm with the
    algebra's edge cases in its hub rows: for min_plus and max_times, hub
    rows 0, 1 and 9 whose extreme is a tie of -0 and +0 (the last +0 in
    rows 0 and 9, -0 in row 1; row 9's ties in different stages), with
    infinities away from the extreme, and hub row 5 holding the opposite
    infinity and the two NaNs of ``FOLD_EDGE_NANS`` (the first must win);
    for Q8.24 (uint32), hub row 0 saturating and row 1 summing to 2^32 -
    2; float32 otherwise."""
    rng = np.random.default_rng(seed)
    n = perm.size
    if alg == "fixed":
        y = rng.integers(0, 1 << 26, (n, n_feat), dtype=np.int64)
        hub = perm == 0
        y[hub] = rng.integers(1 << 31, 1 << 32, (int(hub.sum()), n_feat))
        under = np.flatnonzero(perm == 1)
        y[under] = 0
        y[under[:2]] = ((1 << 32) - 2) >> 1
        return y.astype(np.uint32)
    y = rng.standard_normal((n, n_feat)).astype(np.float32)
    sign = 1.0 if alg == "min_plus" else -1.0   # away from the extreme
    ties = {0: ([1, 4, 9, 20], [-0.0, 0.0, -0.0, 0.0]),
            1: ([1, 4, 9, 20], [0.0, -0.0, 0.0, -0.0]),
            5: ([1, 4, 9, 20], [0.0] * 4),
            9: ([10, 300, 700, 1050], [-0.0, 0.0, -0.0, 0.0])}
    for r, (at, zeros) in ties.items():
        pos = np.flatnonzero(perm == r)
        y[pos] = sign * (np.abs(y[pos]) + 0.5)
        y[pos[3::7]] = sign * np.inf
        y[pos[at]] = np.array(zeros, np.float32)[:, None]
    pos = np.flatnonzero(perm == 5)
    y[pos[5::9]] = -sign * np.inf
    y[pos[30]] = np.uint32(FOLD_EDGE_NANS[0]).view(np.float32)
    y[pos[90]] = np.uint32(FOLD_EDGE_NANS[1]).view(np.float32)
    return y


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
    _need_cuda("device_time_ms")
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


# HBM bandwidth by ``torch.cuda.get_device_name``, GB/s (NVIDIA's data
# sheet: H100 SXM5 80 GB, HBM3), for roofline reporting only
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

# the measured read rate, GB/s, by (device index, device name)
_PEAK_GBPS: dict = {}


def _need_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")


def device_hbm_gbps(name: str | None = None) -> float:
    """The data-sheet HBM bandwidth (GB/s) of the card called ``name``
    (default: CUDA device 0's name).  Raises for a card it does not
    know."""
    if name is None:
        _need_cuda("device_hbm_gbps")
        name = torch.cuda.get_device_name(0)
    if name not in HBM_GBPS:
        raise KeyError(f"no HBM bandwidth on record for {name!r}")
    return HBM_GBPS[name]


def measured_peak_gbps() -> float:
    """The current CUDA device's achievable HBM read rate (GB/s), measured
    once per process and device: an ``amax`` reduction over a 1 GiB fp32
    buffer of random values (twenty times the H100's 50 MB L2, so every
    timed call reads HBM), timed with :func:`device_time_ms` with the
    host's enqueue held out.  BASELINE.md's bar is a share of this
    effective rate; the data-sheet rate (:func:`device_hbm_gbps`) is
    reported beside it, never replaced."""
    _need_cuda("measured_peak_gbps")
    index = torch.cuda.current_device()
    key = (index, torch.cuda.get_device_name(index))
    if key not in _PEAK_GBPS:
        gen = torch.Generator(device="cuda").manual_seed(0)
        a = torch.rand(1 << 28, generator=gen, device="cuda")
        ms = device_time_ms(lambda: torch.amax(a), reps=20, queued=True)
        _PEAK_GBPS[key] = a.numel() * a.element_size() / (ms * 1e-3) / 1e9
        del a
    return _PEAK_GBPS[key]


@dataclasses.dataclass
class SpmvMetrics:
    """The reference's benchmark_result struct (sw/benchmark.cpp:73-87)."""
    name: str
    preproc_s: float
    spmv_ms: float
    gbps: float          # nnz * 8 bytes / t   (benchmark.cpp:313)
    gops: float          # 2 * nnz / t         (benchmark.cpp:314)
    stream_gbps: float   # actual packed bytes / t
    fill: float
    roofline_frac: float        # vs the data-sheet peak (HBM_GBPS)
    roofline_eff: float = 0.0   # vs the measured achievable read rate

    def row(self) -> str:
        eff = (f"/{100*self.roofline_eff:4.1f}% eff"
               if self.roofline_eff else "")
        return (f"{self.name:28s} preproc {self.preproc_s:7.2f} s | "
                f"SpMV {self.spmv_ms:8.4f} ms | {self.gbps:7.1f} GBPS | "
                f"{self.gops:7.1f} GOPS | stream {self.stream_gbps:6.1f} GB/s "
                f"({100*self.roofline_frac:4.1f}% roofline{eff}) | "
                f"fill {self.fill:.2f}")


def measure_spmv(name: str, op, x, nnz: int, stream_bytes: int,
                 preproc_s: float = 0.0, fill: float = 0.0) -> SpmvMetrics:
    """The reference's benchmark row for the SpMV kernel alone: the
    ``wavepack_spmv`` launch of ``op`` (a :class:`SpmvOperator` on the
    card) on natural-order ``x``, or both launches of a ``HybridSpmv``,
    timed with the host's enqueue held out (x's bank blocks are built
    once, before the timing)."""
    from ..ops.spmv import HybridSpmv, wavepack_spmv
    _need_cuda("measure_spmv")
    ops = (op.bulk, op.tail) if isinstance(op, HybridSpmv) else (op,)
    if any(o.device.type != "cuda" for o in ops):
        raise ValueError("measure_spmv times an operator on the card")
    launches = []
    for o in ops:
        xp = torch.as_tensor(x, device=o.device)
        if o.col_order is not None:
            xp = xp[o.col_order]
        launches.append((o.stream_args(xp), o.cfg))

    def run():
        for args, cfg in launches:
            wavepack_spmv(*args, cfg)

    ms = device_time_ms(run, reps=50, queued=True)
    sg = gbps(stream_bytes, ms)
    return SpmvMetrics(
        name=name, preproc_s=preproc_s, spmv_ms=ms, gbps=gbps(nnz * 8, ms),
        gops=gops(nnz, ms), stream_gbps=sg, fill=fill,
        roofline_frac=sg / device_hbm_gbps(),
        roofline_eff=sg / measured_peak_gbps())


def geomean(vals) -> float:
    vals = [v for v in vals if v > 0]
    return float(np.exp(np.mean(np.log(vals)))) if vals else 0.0


def gops(nnz: int, ms: float) -> float:
    return 2.0 * nnz / (ms * 1e-3) / 1e9


def gbps(nbytes: int, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9
