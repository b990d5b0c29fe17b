"""The port's main path as a whole, at a small size, against the JAX
package on the CPU.

A googleplus-shaped power-law matrix (the suite entry is
powerlaw_csr(108000, 108000, 127, 1.2, seed=11)), cut to 4000 rows with
40 nonzeros a row, is packed at the suite's tuned design point for that
entry (bench_tuned.json) with the tile cut to sublanes=256, stripes=128:
block-major with 2 classes a group, steal_mantissa, idx16, split_max=64,
a degree column order, bm_win=bm_adv=1.  Both packages pack it; y goes
through ``hisparse_tpu.SpmvOperator`` in interpret mode and through
``hisparse_tpu_torch.SpmvOperator(device="cpu")``.  Tolerances as in
tests/test_torch_spmv.py: 1e-6 against the interpret-mode reference, 1e-4
against ``spmv_f64``.

The training slice, ``test_training_slice_matches_reference``, cuts the
transformer-70 stand-in of the suite's training row (bench.py,
``diffspmv_tracking_row``: uniform_sparse_csr(512, 33288, 30% density,
seed=70) at sublanes=512, bank_blocks=1, stripes=4 for A and stripes=512
for A^T, steal_mantissa, idx16, split_max=None) to 256 x 2048 at the same
density and sublanes=128 (stripes=4 for A, 128 for A^T).  Both packages
take 3 SGD steps of 0.5 * |A x - y_t|^2 on the stream-layout parameters.
Each step, y is within 1e-6 of the JAX package's, relative to
max(max|y|, 1); both packages then take the JAX package's residual as the
cotangent, so that the last-bit differences of y (the order of the fp32
sums) do not move the steal_mantissa truncation of the updated values.
After each step the port's vA and vT are bit-equal to the JAX package's
(read through ``tile_src``): the gradient streams and the update are
elementwise and rounded alike.

The apps slice, ``test_apps_slice_matches_reference``, cuts the suite's
SSSP row (bench.py, ``sssp_bfs_tracking_rows``: rmat_csr(1632000,
1632000, 19, seed=6), the pokec-shape stand-in, from source 0 at the
default ``SpmvConfig``) to 6000 vertices with 19 edges a vertex on
average.  Both packages run SSSP to the fixpoint, dense and masked: the
distances are bit-equal (min_plus rounds once per term and takes exact
minima), the iteration counts equal, and both within the JAX tests'
rtol=1e-4 of Dijkstra, with the same vertices unreachable.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.golden import spmv_f64
from hisparse_tpu.ops.train_stream import StreamDiffSpmv as RefStream
from hisparse_tpu_torch.interop import stream_from_jax

CFG = dict(sublanes=256, bank_blocks=8, stripes=128, block_major=True,
           classes_per_group=2, steal_mantissa=True, idx16=True,
           two_choice=False)
PACK = dict(split_max=64, col_order="degree", bm_win=1, bm_adv=1)


@functools.lru_cache(maxsize=None)
def slice_case():
    m_r = ht.powerlaw_csr(4000, 4000, 40, 1.2, seed=11)
    m_p = hp.powerlaw_csr(4000, 4000, 40, 1.2, seed=11)
    wr = ht.pack(m_r, ht.SpmvConfig(**CFG), **PACK)
    wp = hp.pack(m_p, hp.SpmvConfig(**CFG), **PACK)
    x = np.random.default_rng(0).random(m_p.num_cols).astype(np.float32)
    op_r = ht.SpmvOperator(wr, interpret=True)
    return m_r, wr, wp, x, op_r(x), np.asarray(op_r(x, renamed=True))


def _err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1.0)


@pytest.mark.parametrize("source", ["port_pack", "npz", "from_arrays"])
def test_slice_matches_reference(source, tmp_path):
    """pack -> SpmvOperator -> natural-order y, with the pack made by the
    port, or made by the JAX package and carried over."""
    m_r, wr, wp, x, y_ref, y_ref_renamed = slice_case()
    if source == "npz":
        ht.save_wavepack(tmp_path / "slice.npz", wr)
        wp = hp.load_wavepack(tmp_path / "slice.npz")
    elif source == "from_arrays":
        wp = hp.wavepack_from_arrays(**vars(wr))
    assert dataclasses.asdict(wp.config) == CFG | dict(dtype="fp32",
                                                       semiring="plus_times")
    assert wp.num_tiles == wr.num_tiles and wp.nnz == m_r.nnz
    op = hp.SpmvOperator(wp, device="cpu")
    y = op(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (m_r.num_rows,)
    assert torch.isfinite(y).all()
    assert _err(y, y_ref) <= 1e-6
    assert _err(y, spmv_f64(m_r, x)) <= 1e-4
    y_renamed = op(torch.from_numpy(x), renamed=True)
    assert _err(y_renamed, y_ref_renamed) <= 1e-6


TRAIN_CFG = dict(sublanes=128, bank_blocks=1, stripes=4,
                 steal_mantissa=True, idx16=True, two_choice=False)
TRAIN_CFG_T = dict(TRAIN_CFG, stripes=128)


def test_training_slice_matches_reference():
    import jax
    import jax.numpy as jnp
    args = (256, 2048, int(2048 * 0.30))
    ref = RefStream(ht.uniform_sparse_csr(*args, seed=70),
                    ht.SpmvConfig(**TRAIN_CFG), ht.SpmvConfig(**TRAIN_CFG_T),
                    interpret=True, split_max=None)
    sd = hp.StreamDiffSpmv(hp.uniform_sparse_csr(*args, seed=70),
                           hp.SpmvConfig(**TRAIN_CFG),
                           hp.SpmvConfig(**TRAIN_CFG_T), device="cpu",
                           split_max=None)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(sd.num_cols).astype(np.float32)
    y_t = rng.standard_normal(sd.num_rows).astype(np.float32)
    lr = 1e-3
    f, aux = ref.fn()

    def ref_loss(vA, vT):
        r = f(vA, vT, jnp.asarray(x), aux) - jnp.asarray(y_t)
        return 0.5 * jnp.vdot(r, r)

    vjp = jax.jit(lambda vA, vT, g: jax.vjp(
        lambda a, b: f(a, b, jnp.asarray(x), aux), vA, vT)[1](g))
    vA, vT = ref.vA0, ref.vT0
    losses = []
    for _ in range(3):
        y_ref = np.asarray(f(vA, vT, jnp.asarray(x), aux))
        y = sd(torch.from_numpy(x))
        assert _err(y.detach(), y_ref) <= 1e-6
        # one cotangent for both packages: the JAX package's residual
        g = y_ref - y_t
        losses.append(0.5 * float(np.dot(g, g)))
        vA, vT = ref.sgd_step(vA, vT, *vjp(vA, vT, jnp.asarray(g)), lr)
        sd.zero_grad()
        y.backward(torch.from_numpy(g))
        sd.sgd_step(lr)
        np.testing.assert_array_equal(
            sd.vA.detach().numpy(), stream_from_jax(vA, ref.d.op.tile_src))
        np.testing.assert_array_equal(
            sd.vT.detach().numpy(), stream_from_jax(vT, ref.d.opT.tile_src))
        np.testing.assert_array_equal(sd.values(), sd.values_T())
    assert losses[-1] < losses[0]


def test_apps_slice_matches_reference():
    from hisparse_tpu.models.apps import SSSP as RefSSSP
    m_r = ht.rmat_csr(6000, 6000, 19, seed=6)
    m_p = hp.rmat_csr(6000, 6000, 19, seed=6)
    ref = RefSSSP(m_r, interpret=True)
    ss = hp.SSSP(m_p, device="cpu")
    assert ss.wp.num_tiles == ref.wp.num_tiles
    dijkstra = hp.sssp_reference(m_p, 0)
    fin = np.isfinite(dijkstra)
    for masked in (False, True):
        d = ss.run(source=0, masked=masked).numpy()
        np.testing.assert_array_equal(d, ref.run(source=0, masked=masked))
        assert ss.iters_run == ref.iters_run
        assert (np.isfinite(d) == fin).all()
        np.testing.assert_allclose(d[fin], dijkstra[fin], rtol=1e-4,
                                   atol=1e-5)
    assert len(ss.tiles_streamed) == ss.iters_run
