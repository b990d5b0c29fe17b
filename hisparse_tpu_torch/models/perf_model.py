"""Analytical performance model, the port of
``hisparse_tpu/models/perf_model.py`` (itself the port of
performance_model.cpp:430-444) on the H100's measured rates.

The reference models one SpMV as
    T = max(TM, TV) + TW,   p = min(alpha, beta) * total_lanes,
with alpha = shuffle efficiency (ideal/actual iterations), beta = payload
fraction of the padded CPSR stream, TM = matrix stream time, TV = vector
reload time, TW = result writeback time.

Mapping:
  * beta  -> wavepack fill (true nnz / padded slots), computed exactly by
    the packer.
  * alpha -> wave-scheduling efficiency: optimum waves / scheduled waves
    (``Wavepack.alpha``).
  * TM -> stream bytes / HBM bandwidth; compute bound -> slots / slot_rate
    (the SpMV kernel's slot rate on the card, by gather-operand count);
    TV -> x (re)load traffic; TW -> y writeback traffic.

The rates are the card's, measured by ``python -m
hisparse_tpu_torch.models.calibrate`` on the H100 and committed as
``rates_h100.json`` beside this module (with the card's name and power
limit).  This module and the format dispatch (``ops/dense.py``) read that
file alone: without it they raise, and no rate of another chip stands in.
Every function that needs rates also takes them as ``rates=`` (a dict of
the file's layout).

XT residency is the card's: the kernel reads x through XT, n_parts * CT
bank blocks of 64 KB, which loads from HBM once when it fits the 50 MB L2
(hopper-kernels guide, section 1) and once per row block otherwise.
"""
from __future__ import annotations

import dataclasses
import json
import os

from ..config import LANES, SpmvConfig
from ..formats.csr import CSRMatrix
from ..formats.wavepack import Wavepack

RATES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "rates_h100.json")
HBM_GBPS = 3350.0              # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20        # H100 L2
_XT_BLOCK_BYTES = 128 * 128 * 4
_loaded: dict = {}


def card_rates(path: str | None = None) -> dict:
    """The measured rates file (``rates_h100.json`` unless ``path`` names
    another), read once: slot-rate tables ``select_chain``,
    ``block_major``, ``select_chain_idx16`` and ``block_major_idx16``
    (Gslot/s by gather-operand count), the two-choice multipliers
    ``tc_mult_chain`` and ``tc_mult_bm``, and the format dispatch's stream
    rates ``dense_bf16_gbps``, ``bcsr_bf16_gbps`` and ``wavepack_gbps``.
    Raises ``FileNotFoundError`` when the file is missing."""
    path = path or RATES_PATH
    if path not in _loaded:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} is missing: run `python -m "
                "hisparse_tpu_torch.models.calibrate` on the card; the "
                "perf model and the format dispatch have no fallback rates")
        with open(path) as f:
            _loaded[path] = json.load(f)
    return _loaded[path]


def _table(rates: dict, key: str) -> dict | None:
    if key not in rates:
        return None
    return {int(k): float(v) for k, v in rates[key].items()}


def tc_multiplier(block_major: bool, rates: dict | None = None) -> float:
    """Measured two-choice slot-rate multiplier (beyond operand count)."""
    rates = card_rates() if rates is None else rates
    return float(rates["tc_mult_bm" if block_major else "tc_mult_chain"])


def slot_rate(n_operands: int, block_major: bool = False,
              idx16: bool = False, rates: dict | None = None) -> float:
    """Measured sustained slot rate (Gslot/s) of the SpMV kernel.  idx16
    streams use their own table where the calibration has one, else the
    idx32 table; linear interpolation between measured operand counts."""
    rates = card_rates() if rates is None else rates
    table = None
    if idx16:
        table = _table(rates, "block_major_idx16" if block_major
                       else "select_chain_idx16")
    if table is None:
        table = _table(rates, "block_major" if block_major
                       else "select_chain")
    ks = sorted(table)
    if n_operands in table:
        return table[n_operands]
    lo = max([k for k in ks if k < n_operands], default=ks[0])
    hi = min([k for k in ks if k > n_operands], default=ks[-1])
    if lo == hi:
        return table[lo]
    f = (n_operands - lo) / (hi - lo)
    return table[lo] * (1 - f) + table[hi] * f


@dataclasses.dataclass
class PerfEstimate:
    gops: float
    time_s: float
    bound: str            # 'hbm-stream' | 'compute' | 'x-reload'
    alpha: float          # scheduling efficiency
    beta: float           # fill
    tm_s: float
    tv_s: float
    tw_s: float

    def row(self) -> str:
        return (f"est {self.gops:7.1f} GOPS  bound={self.bound:10s} "
                f"alpha={self.alpha:.2f} beta={self.beta:.2f} "
                f"TM={self.tm_s*1e6:.1f}us TV={self.tv_s*1e6:.1f}us "
                f"TW={self.tw_s*1e6:.1f}us")


def xt_fits_l2(cfg: SpmvConfig, n_parts: int) -> bool:
    """Whether the pack's XT (n_parts * CT bank blocks of 64 KB) fits the
    card's L2, so x loads from HBM once."""
    return n_parts * cfg.total_blocks * _XT_BLOCK_BYTES <= L2_BYTES


def estimate(m: CSRMatrix, cfg: SpmvConfig, wp: Wavepack,
             hbm_gbps: float = HBM_GBPS,
             rates: dict | None = None) -> PerfEstimate:
    return estimate_pack(wp, hbm_gbps, rates)


def estimate_pack(wp: Wavepack, hbm_gbps: float = HBM_GBPS,
                  rates: dict | None = None) -> PerfEstimate:
    """Estimate from the pack alone (everything needed is on the Wavepack:
    nnz, fill, measured alpha, stream bytes, geometry)."""
    cfg = wp.config
    nnz = wp.nnz
    slots = wp.num_tiles * cfg.tile_slots
    beta = wp.fill
    alpha = wp.alpha

    tm = wp.stream_bytes / (hbm_gbps * 1e9)
    n_ops = (cfg.classes_per_group if cfg.block_major
             else cfg.total_blocks)
    rate = slot_rate(n_ops, cfg.block_major, cfg.idx16, rates)
    if cfg.two_choice:
        rate *= tc_multiplier(cfg.block_major, rates)
    tc = slots / (rate * 1e9)
    # single-partition packs read XT once whatever its size: every row
    # block walks the same partition
    x_once = xt_fits_l2(cfg, wp.n_parts) or wp.n_parts == 1
    x_bytes = wp.n_parts * cfg.vb_cols * 4 * (1 if x_once else wp.n_blocks)
    tv = x_bytes / (hbm_gbps * 1e9)
    tw = wp.n_blocks * cfg.stripes * LANES * 4 / (hbm_gbps * 1e9)

    terms = [(tm, "hbm-stream"), (tc, "compute"), (tv, "x-reload")]
    stream_t, bound = max(terms, key=lambda e: e[0])
    t = stream_t + tw
    return PerfEstimate(gops=2 * nnz / t / 1e9, time_s=t, bound=bound,
                        alpha=alpha, beta=beta, tm_s=tm, tv_s=tv, tw_s=tw)
