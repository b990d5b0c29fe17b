"""The port's dense arm, perf model, DSE and format dispatch against the JAX
package's on the CPU.

``DenseOperator`` and ``SpmmOperator`` are plain products in both
packages; the port's bf16 product upcasts on the CPU (a product of two bf16
values is exact in fp32), so only the order of the fp32 sums differs from
the JAX ``jnp.dot``: 1e-6 of max|y|.  The perf model and the DSE's
``sample_rows`` are compared with the JAX package's on the same packs,
the model with the JAX rate tables passed in.  ``choose_format`` runs on
the card's committed rates (``models/rates_h100.json``): its picks on
tests/test_dense.py's fixtures are asserted for the card.
"""
import json
import os

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu_torch.models import dse, perf_model
from hisparse_tpu_torch.ops import dense
from hisparse_tpu_torch.ops.dense import (block_count, block_count_exact,
                                          block_count_sampled, format_times,
                                          wavepack_time_per_nnz)

TOL = 1e-6
JAX_RATES_PATH = os.path.join(os.path.dirname(ht.__file__), "models",
                              "slot_rates.json")


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_rates() -> dict:
    with open(JAX_RATES_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_matches_reference(dtype):
    from hisparse_tpu.ops.dense import DenseOperator as HtDense
    args = (200, 300, 30) if dtype == "fp32" else (100, 200, 20)
    seed = 1 if dtype == "fp32" else 2
    x = np.random.default_rng(seed).random(args[1]).astype(np.float32)
    y_ref = np.asarray(HtDense(ht.uniform_sparse_csr(*args, seed=seed),
                               dtype=dtype)(x))
    op = hp.DenseOperator(hp.uniform_sparse_csr(*args, seed=seed), dtype,
                          device="cpu")
    y = op(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (args[0],)
    assert _err(y, y_ref) <= TOL
    assert op.stream_bytes == op.a.numel() * (2 if dtype == "bf16" else 4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_spmm_operator_matches_reference(dtype):
    from hisparse_tpu.ops.dense import SpmmOperator as HtSpmm
    X = np.random.default_rng(2).random((250, 64)).astype(np.float32)
    Y_ref = np.asarray(HtSpmm(ht.uniform_sparse_csr(150, 250, 25, seed=3),
                              dtype=dtype)(X))
    Y = hp.SpmmOperator(hp.uniform_sparse_csr(150, 250, 25, seed=3), dtype,
                        device="cpu")(torch.from_numpy(X))
    assert Y.shape == (150, 64) and Y.dtype == torch.float32
    assert _err(Y, Y_ref) <= TOL


def test_block_count_exact_matches_reference():
    """Up to sample_nnz the count is exact: the nonempty blocks the JAX
    package's pack_bcsr densifies."""
    from hisparse_tpu.ops.bcsr import pack_bcsr as ht_pack_bcsr
    for args, seed in (((500, 700, 20), 6), ((1000, 10000, 5), 5)):
        m_r = ht.powerlaw_csr(*args, seed=seed)
        nb_ref = np.asarray(ht_pack_bcsr(m_r)[1]).size
        assert block_count(hp.powerlaw_csr(*args, seed=seed)) == nb_ref


def test_block_count_sampled_matches_reference():
    """The sampled helper is the JAX choose_format's count
    (hisparse_tpu/ops/dense.py:158-165, the arithmetic inline there).
    ``block_count`` no longer takes it for this matrix: its 16 x 24 block
    grid fits the exact bitmap, so the helper is called directly, with
    a sample small enough for its sampled branch."""
    m = hp.uniform_sparse_csr(2000, 3000, 10, seed=8)
    m_r = ht.uniform_sparse_csr(2000, 3000, 10, seed=8)
    sample = 1000
    nbc = -(-m_r.num_cols // 128)
    take = np.linspace(0, m_r.nnz - 1, sample).astype(np.int64)
    rows = np.searchsorted(m_r.indptr, take, side="right") - 1
    key = (rows // 128).astype(np.int64) * nbc + m_r.indices[take] // 128
    nb_ref = int(np.unique(key).size * max(1.0, m_r.nnz / sample) ** 0.5)
    assert block_count_sampled(m, sample) == nb_ref
    assert block_count_sampled(m) == block_count(m)     # exact below


@pytest.mark.parametrize("chunk", [1 << 22, 1000])
def test_block_count_exact_above_the_sample(chunk):
    """Where the block grid fits the bitmap, the count is exact however
    many nonzeros the matrix has beyond the sample: the blocks the JAX
    package's pack_bcsr densifies, also when the bitmap is marked in
    chunks smaller than a block row."""
    from hisparse_tpu.ops.bcsr import pack_bcsr as ht_pack_bcsr
    m = hp.block_structured_csr(2048, 1536, block_rows=3, seed=2)
    m_r = ht.block_structured_csr(2048, 1536, block_rows=3, seed=2)
    nb_ref = np.asarray(ht_pack_bcsr(m_r)[1]).size
    assert block_count_exact(m, chunk) == nb_ref
    assert block_count(m, sample_nnz=1000) == nb_ref
    assert block_count_sampled(m, 1000) > nb_ref       # the estimate's bias


def test_block_count_above_the_bitmap(monkeypatch):
    """A block grid of more than BLOCK_BITMAP_CELLS cells takes the
    sampled estimate."""
    m = hp.uniform_sparse_csr(2000, 3000, 10, seed=8)
    monkeypatch.setattr(dense, "BLOCK_BITMAP_CELLS", 16 * 24 - 1)
    assert block_count(m, 1000) == block_count_sampled(m, 1000)
    monkeypatch.setattr(dense, "BLOCK_BITMAP_CELLS", 16 * 24)
    assert block_count(m, 1000) == block_count_exact(m)


@pytest.mark.parametrize("case", ["rows", "nnz-cap", "whole"])
def test_sample_rows_matches_reference(case):
    from hisparse_tpu.models.dse import sample_rows as ht_sample_rows
    gen, args, kw, max_rows = {
        "rows": ("powerlaw_csr", (5000, 1000, 5), dict(seed=2), 500),
        "nnz-cap": ("uniform_sparse_csr", (600, 4000, 3000), dict(seed=4),
                    10_000),
        "whole": ("uniform_sparse_csr", (300, 400, 4), dict(seed=1), 500),
    }[case]
    s_r = ht_sample_rows(getattr(ht, gen)(*args, **kw), max_rows)
    s_p = dse.sample_rows(getattr(hp, gen)(*args, **kw), max_rows)
    assert (s_p.num_rows, s_p.num_cols) == (s_r.num_rows, s_r.num_cols)
    for f in ("data", "indices", "indptr"):
        a, b = getattr(s_p, f), getattr(s_r, f)
        assert (a.dtype, a.tobytes()) == (b.dtype, b.tobytes()), f


def test_slot_rate_matches_reference():
    """slot_rate and the two-choice multipliers read the tables they are
    given as the JAX package reads its own."""
    from hisparse_tpu.models import perf_model as ht_pm
    rates = jax_rates()
    for bm in (False, True):
        assert perf_model.tc_multiplier(bm, rates) == ht_pm.tc_multiplier(bm)
        for idx16 in (False, True):
            for n in range(1, 17):
                assert perf_model.slot_rate(n, bm, idx16, rates) == \
                    ht_pm.slot_rate(n, bm, idx16)


ESTIMATE_CASES = {
    "chain": (dict(sublanes=128, bank_blocks=1, stripes=128),
              ("uniform_sparse_csr", (2000, 3000, 16), 1)),
    "chain-tc": (dict(sublanes=256, bank_blocks=2, stripes=64),
                 ("powerlaw_csr", (3000, 20000, 9), 2)),
    "bm-idx16": (dict(sublanes=512, bank_blocks=4, stripes=512,
                      block_major=True, classes_per_group=2,
                      steal_mantissa=True, idx16=True, two_choice=False),
                 ("powerlaw_csr", (20000, 60000, 12), 3)),
    "multipart": (dict(sublanes=128, bank_blocks=1, stripes=32),
                  ("powerlaw_csr", (4196, 16684, 5), 4)),
}


@pytest.mark.parametrize("case", list(ESTIMATE_CASES))
def test_estimate_pack_matches_reference(case):
    """alpha, beta, TM, TW and the compute term equal the JAX model's on
    the same pack, with the JAX tables and HBM rate passed in; TV follows
    the card's L2 residency (equal here: every pack's XT fits)."""
    from hisparse_tpu.models.perf_model import estimate_pack as ht_est
    kw, (gen, args, seed) = ESTIMATE_CASES[case]
    wr = ht.pack(getattr(ht, gen)(*args, seed=seed), ht.SpmvConfig(**kw))
    wp = hp.pack(getattr(hp, gen)(*args, seed=seed), hp.SpmvConfig(**kw))
    ref = ht_est(wr, 819.0)
    got = perf_model.estimate_pack(wp, 819.0, rates=jax_rates())
    assert perf_model.xt_fits_l2(wp.config, wp.n_parts)
    for f in ("alpha", "beta", "tm_s", "tv_s", "tw_s", "time_s", "gops",
              "bound"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.bound in ("hbm-stream", "compute", "x-reload")


def test_estimate_x_reload_past_l2():
    """A pack whose XT outgrows the L2 reloads x once per row block."""
    cfg = hp.SpmvConfig(sublanes=128, bank_blocks=8, stripes=32,
                        two_choice=True)
    wp = hp.pack(hp.powerlaw_csr(9000, 60 * cfg.vb_cols, 4, seed=5), cfg)
    assert wp.n_parts == 60 and wp.n_blocks > 1
    assert not perf_model.xt_fits_l2(cfg, wp.n_parts)
    est = perf_model.estimate_pack(wp, rates=jax_rates())
    x_bytes = wp.n_parts * cfg.vb_cols * 4 * wp.n_blocks
    assert est.tv_s == x_bytes / (perf_model.HBM_GBPS * 1e9)


def test_dse_explore_and_best_config(tmp_path):
    m = hp.uniform_sparse_csr(1500, 2000, 10, seed=3)
    grid = [(hp.SpmvConfig(sublanes=128, bank_blocks=1, stripes=r), None)
            for r in (32, 128)]
    pts = dse.explore([("u", m)], grid=grid, rates=jax_rates(),
                      csv_path=str(tmp_path / "dse.csv"))
    assert len(pts) == 2 and pts[0].gops_geomean >= pts[1].gops_geomean
    assert (tmp_path / "dse.csv").read_text().count("\n") == 3
    cfg, split = dse.best_config(m, grid=grid, rates=jax_rates())
    assert cfg == pts[0].cfg and split is None
    assert len(dse.default_grid()) > 50


def test_rates_file_names_the_card():
    """The committed rates come from a card run: the file names an H100
    and its power limit, as nvidia-smi prints them, and holds every rate
    the model and the dispatch read."""
    rates = perf_model.card_rates()
    assert "H100" in rates["device"] and rates["device"].endswith(" W")
    for key in ("select_chain", "block_major", "select_chain_idx16",
                "block_major_idx16"):
        assert rates[key] and all(v > 0 for v in rates[key].values())
    for key in ("tc_mult_chain", "tc_mult_bm", "dense_bf16_gbps",
                "bcsr_bf16_gbps", "wavepack_gbps"):
        assert rates[key] > 0


def test_no_rates_no_dispatch(tmp_path, monkeypatch):
    """Without the rates file the model and the dispatch raise: no rate
    of another chip stands in."""
    missing = str(tmp_path / "rates_h100.json")
    monkeypatch.setattr(perf_model, "RATES_PATH", missing)
    with pytest.raises(FileNotFoundError):
        perf_model.card_rates()
    with pytest.raises(FileNotFoundError):
        perf_model.slot_rate(2)
    with pytest.raises(FileNotFoundError):
        hp.choose_format(hp.uniform_sparse_csr(64, 64, 32, seed=4))


def test_choose_format_on_card_rates():
    """tests/test_dense.py's picks on the card's rates: a 50%-dense matrix
    goes dense, a 0.05%-dense one wavepack, and the density ladder stays
    monotone."""
    assert hp.choose_format(hp.uniform_sparse_csr(64, 64, 32,
                                                  seed=4)) == "dense"
    assert hp.choose_format(hp.uniform_sparse_csr(1000, 10000, 5,
                                                  seed=5)) == "wavepack"
    picks = [hp.choose_format(hp.uniform_sparse_csr(512, 4096, avg, seed=8))
             for avg in (8, 2000)]
    assert picks == ["wavepack", "dense"]


def test_choose_format_crossover_calibrated():
    """In the band where the wavepack prior lands within 2.5x of the best
    other arm, the dispatch asks the perf model on a sampled pack, and its
    pick agrees with that explicit comparison on the card's rates."""
    rates = perf_model.card_rates()
    for avg in (80, 160, 320):
        m = hp.uniform_sparse_csr(512, 4096, avg, seed=8)
        t = format_times(m, calibrate=False)
        t_alt = min(t["dense"], t["bcsr"])
        if not t_alt / 2.5 < t["wavepack"] < t_alt * 2.5:
            continue
        t_wave = wavepack_time_per_nnz(m, rates=rates)
        got = hp.choose_format(m)
        assert got == ("wavepack" if t_wave < t_alt else
                       min(("bcsr", "dense"), key=lambda k: t[k]))
        return
    pytest.fail("no matrix of the ladder fell in the calibration band")


def test_choose_format_block_structured():
    """A matrix whose nonzeros fill few dense blocks: the bcsr arm's cost
    is its blocks' bytes, which the dispatch weighs against the others."""
    m = hp.block_structured_csr(2048, 2048, block_rows=2, seed=7)
    t = format_times(m)
    assert t["bcsr"] == (2.0 * 128 * 128 * block_count(m) / m.nnz
                         / perf_model.card_rates()["bcsr_bf16_gbps"])
    assert hp.choose_format(m) == min(t, key=t.get)


def test_choose_format_counts_blocks_exactly():
    """A block-structured matrix that the sampled block count sent to the
    dense arm goes to BCSR: with 30,000 sampled nonzeros the JAX estimate
    scales 64 blocks to 291, which costs BCSR more than dense; the exact
    count keeps it the cheapest arm, as bcsr-spmm-16k on the card."""
    m = hp.block_structured_csr(2048, 2048, block_rows=4, seed=7)
    rate = perf_model.card_rates()["bcsr_bf16_gbps"]
    t = format_times(m, sample_nnz=30_000)
    t_sampled = (2.0 * 128 * 128 * block_count_sampled(m, 30_000) / m.nnz
                 / rate)
    assert block_count(m, 30_000) == 64
    assert t_sampled > t["dense"] > t["bcsr"]
    assert hp.choose_format(m, sample_nnz=30_000) == "bcsr"
