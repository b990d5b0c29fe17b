"""Measure the card's rates for the perf model and the format dispatch and
write ``rates_h100.json`` beside this module.

    python -m hisparse_tpu_torch.models.calibrate [--dry] [--out PATH]

The port of ``scripts/calibrate_slot_rates.py`` (the analog of the
reference's instrumented-csim calibration, performance_model/include/
shuffle.h:199,279), on one NVIDIA GPU.  It measures, with the kernels'
host enqueue held out (``utils/bench.device_time_ms(queued=True)``):

  * the SpMV kernel's sustained slot rate (Gslot/s = padded slots / kernel
    time) on the JAX script's fixtures: ``uniform_sparse_csr(65536,
    B*16384, 32, seed=7)`` packed at S = R = 512 with steal_mantissa,
    select-chain by total gather operands (B in 1, 2, 4, 8, 16), block-major
    by classes_per_group (B = 8, K in 1, 2, 4, 8), the two-choice
    multipliers at matched operand count, and the idx16 tables;
  * ``wavepack_gbps``: the stream bytes over the kernel time of the B = 2
    select-chain point (8 B a slot: the wavepack prior of choose_format);
  * ``dense_bf16_gbps``: the bf16 matrix's bytes over the time of the
    dense arm's product (``ops/dense.dense_mm``) at the transformer_50 shape
    (``uniform_sparse_csr(512, 33288, 16644, seed=50)``, bench.py:533-537);
  * ``bcsr_bf16_gbps``: the bf16 blocks' bytes over the BCSR kernel's time
    on bcsr-spmm-16k (``block_structured_csr(16384, 16384, block_rows=24,
    seed=7)``, bench.py:897-921) with 64 right-hand sides.

The file records the card as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints it.  Without a CUDA device this exits
non-zero and writes nothing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

FIXTURE_ROWS, FIXTURE_NNZ_PER_ROW = 65536, 32


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


def measure_point(cfg) -> tuple[float, float, float]:
    """(Gslot/s, fill, stream GB/s) of the SpMV kernel on the fixture of
    ``cfg``: ``uniform_sparse_csr(65536, B*16384, 32, seed=7)``."""
    import torch
    from ..formats.csr import uniform_sparse_csr
    from ..formats.wavepack import pack
    from ..ops.spmv import SpmvOperator, wavepack_spmv
    from ..utils.bench import device_time_ms
    m = uniform_sparse_csr(FIXTURE_ROWS, cfg.bank_blocks * 16384,
                           FIXTURE_NNZ_PER_ROW, seed=7)
    wp = pack(m, cfg, split_max=None)
    op = SpmvOperator(wp, device="cuda")
    x = torch.from_numpy(np.random.default_rng(0).random(
        m.num_cols).astype(np.float32)).cuda()
    args = op.stream_args(x)
    ms = device_time_ms(lambda: wavepack_spmv(*args, cfg), reps=20,
                        queued=True)
    slots = wp.num_tiles * cfg.tile_slots
    return (slots / (ms * 1e-3) / 1e9, wp.fill,
            wp.stream_bytes / (ms * 1e-3) / 1e9)


def slot_tables(log) -> dict:
    """The slot-rate tables and two-choice multipliers (the JAX script's
    points, all measured two_choice=False except the two multipliers)."""
    from ..config import SpmvConfig

    def point(what, **kw):
        cfg = SpmvConfig(sublanes=512, stripes=512, steal_mantissa=True,
                         **kw)
        rate, fill, gbps = measure_point(cfg)
        log(f"{what}: {rate:.3f} Gslot/s (fill {fill:.4f}, stream "
            f"{gbps:.1f} GB/s)")
        return cfg, rate, gbps

    out = {"select_chain": {}, "block_major": {}, "select_chain_idx16": {},
           "block_major_idx16": {}}
    for B in (1, 2, 4, 8, 16):
        cfg, rate, gbps = point(f"select-chain B={B}", bank_blocks=B,
                                two_choice=False)
        out["select_chain"][cfg.total_blocks] = rate
        if B == 2:
            out["wavepack_gbps"] = gbps
    _, rate_tc, _ = point("select-chain B=8 two_choice (16 operands)",
                          bank_blocks=8, two_choice=True)
    out["tc_mult_chain"] = rate_tc / out["select_chain"][16]
    for K in (1, 2, 4, 8):
        _, rate, _ = point(f"block-major K={K}", bank_blocks=8,
                           two_choice=False, block_major=True,
                           classes_per_group=K)
        out["block_major"][K] = rate
    _, rate_tc, _ = point("block-major K=4 two_choice", bank_blocks=8,
                          two_choice=True, block_major=True,
                          classes_per_group=4)
    out["tc_mult_bm"] = rate_tc / out["block_major"][4]
    for B in (2, 8):
        cfg, rate, _ = point(f"select-chain idx16 B={B}", bank_blocks=B,
                             two_choice=False, idx16=True)
        out["select_chain_idx16"][cfg.total_blocks] = rate
    for K in (1, 2, 4):
        _, rate, _ = point(f"block-major idx16 K={K}", bank_blocks=8,
                           two_choice=False, block_major=True,
                           classes_per_group=K, idx16=True)
        out["block_major_idx16"][K] = rate
    return out


def dense_rate(log) -> float:
    """GB/s of the bf16 dense arm's product at the transformer_50 shape."""
    import torch
    from ..formats.csr import uniform_sparse_csr
    from ..ops.dense import DenseOperator, dense_mm
    from ..utils.bench import device_time_ms
    m = uniform_sparse_csr(512, 33288, int(33288 * 0.5), seed=50)
    op = DenseOperator(m, "bf16", device="cuda")
    xp = op.padded(torch.from_numpy(np.random.default_rng(0).random(
        m.num_cols).astype(np.float32)).cuda())
    ms = device_time_ms(lambda: dense_mm(op.a, xp), reps=50, queued=True)
    gbps = op.stream_bytes / (ms * 1e-3) / 1e9
    log(f"dense bf16 transformer_50 {tuple(op.a.shape)}: {ms:.4f} ms, "
        f"{gbps:.1f} GB/s of {op.stream_bytes / 1e6:.1f} MB")
    return gbps


def bcsr_rate(log) -> float:
    """GB/s of the BCSR kernel's bf16 blocks on bcsr-spmm-16k, 64 RHS."""
    import torch
    from ..formats.csr import block_structured_csr
    from ..ops.bcsr import BcsrOperator, bcsr_spmm
    from ..utils.bench import device_time_ms
    m = block_structured_csr(16384, 16384, block_rows=24, seed=7)
    op = BcsrOperator(m, torch.bfloat16, device="cuda")
    xp = op.padded_x(torch.from_numpy(np.random.default_rng(1).random(
        (m.num_cols, 64)).astype(np.float32)).cuda())
    ms = device_time_ms(lambda: bcsr_spmm(op.blocks, op.brow_ptr, op.bcol,
                                          xp), reps=20, queued=True)
    gbps = op.stream_bytes / (ms * 1e-3) / 1e9
    log(f"bcsr bf16 bcsr-spmm-16k ({op.blocks.shape[0]} blocks, 64 rhs): "
        f"{ms:.4f} ms, {gbps:.1f} GB/s of {op.stream_bytes / 1e6:.1f} MB")
    return gbps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dry", action="store_true",
                    help="print the rates without writing the file")
    ap.add_argument("--out", default=None,
                    help="where to write (default: rates_h100.json beside "
                         "this module)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA device "
                         "(torch.cuda.is_available() is false)")
    from .perf_model import RATES_PATH

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    device = card_name()
    log(device)
    rates = {"device": device,
             "script": "python -m hisparse_tpu_torch.models.calibrate"}
    rates.update(slot_tables(log))
    rates["dense_bf16_gbps"] = dense_rate(log)
    rates["bcsr_bf16_gbps"] = bcsr_rate(log)
    print(json.dumps(rates), flush=True)
    if not args.dry:
        path = args.out or RATES_PATH
        with open(path, "w") as f:
            json.dump(rates, f, indent=1)
        log(f"wrote {path}")


if __name__ == "__main__":
    main()
