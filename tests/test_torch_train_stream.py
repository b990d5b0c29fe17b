"""The port's StreamDiffSpmv and gradient stream against the JAX package's
on the CPU.

The same matrices and numpy-seeded inputs go through
``hisparse_tpu.ops.train_stream.StreamDiffSpmv`` in interpret mode (on the
four configs of tests/test_train_stream.py) and through the port's
``StreamDiffSpmv(device="cpu")``.  The JAX operators may append identity
pad tiles to a stream; every stream comparison goes through the JAX
operator's ``tile_src`` (``interop.stream_from_jax``).  Tolerances:

  * y and x_bar within 1e-6 of the interpret-mode reference, as
    max|d| / max(max|ref|, 1): only the order of fp32 sums may differ;
  * the parameter streams, their masks and both gradient streams
    bit-equal: one product per slot, rounded in the same order;
  * the plain gradient stream bit-equal to ``_gradstream_call`` in
    interpret mode on packs of every routing kind.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.spmv import _gradstream_call
from hisparse_tpu.ops.train_stream import StreamDiffSpmv as RefStream
from hisparse_tpu_torch.interop import stream_from_jax
from hisparse_tpu_torch.ops import _kernels
from hisparse_tpu_torch.ops.spmv import (build_xt, gradstream_tiles_plain,
                                         wavepack_gradstream)

TOL_REF = 1e-6

CFGS = {
    "chain": dict(sublanes=128, bank_blocks=2, stripes=128),
    "chain_tc": dict(sublanes=128, bank_blocks=2, stripes=128,
                     two_choice=True),
    "bm_steal": dict(sublanes=128, bank_blocks=2, stripes=128,
                     block_major=True, classes_per_group=2,
                     steal_mantissa=True, two_choice=False),
    "steal_idx16": dict(sublanes=128, bank_blocks=2, stripes=128,
                        steal_mantissa=True, idx16=True, two_choice=False),
}


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_stream_matches_reference(kind):
    ref = RefStream(ht.powerlaw_csr(900, 800, 6, seed=11),
                    ht.SpmvConfig(**CFGS[kind]), interpret=True)
    sd = hp.StreamDiffSpmv(hp.powerlaw_csr(900, 800, 6, seed=11),
                           hp.SpmvConfig(**CFGS[kind]), device="cpu")
    srcA, srcT = ref.d.op.tile_src, ref.d.opT.tile_src
    for a, b in ((sd.vA, stream_from_jax(ref.vA0, srcA)),
                 (sd.vT, stream_from_jax(ref.vT0, srcT)),
                 (sd.maskA, stream_from_jax(ref.aux["maskA"], srcA)),
                 (sd.maskT, stream_from_jax(ref.aux["maskT"], srcT))):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    rng = np.random.default_rng(13)
    x = rng.standard_normal(sd.num_cols).astype(np.float32)
    g = rng.standard_normal(sd.num_rows).astype(np.float32)
    f, aux = ref.fn()
    y_ref = np.asarray(ref(x))
    gA_ref, gT_ref, gx_ref = jax.grad(
        lambda vA, vT, xx: jnp.vdot(f(vA, vT, xx, aux), jnp.asarray(g)),
        argnums=(0, 1, 2))(ref.vA0, ref.vT0, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = sd(xt)
    y.backward(torch.from_numpy(g))
    assert _err(y.detach(), y_ref) <= TOL_REF
    assert _err(xt.grad, gx_ref) <= TOL_REF
    np.testing.assert_array_equal(sd.vA.grad.numpy(),
                                  stream_from_jax(gA_ref, srcA))
    np.testing.assert_array_equal(sd.vT.grad.numpy(),
                                  stream_from_jax(gT_ref, srcT))
    # both layouts' gradients are the pattern-restricted outer product
    m = sd.m
    rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
    np.testing.assert_array_equal(sd.grads_csr(sd.vA.grad),
                                  g[rows] * x[m.indices])


@pytest.mark.parametrize("kind", ["chain", "bm_steal"])
def test_stream_layouts_stay_bit_consistent(kind):
    """Identical elementwise updates keep the two layouts bit-equal, the
    loss falls, and pad slots stay at the identity."""
    sd = hp.StreamDiffSpmv(hp.powerlaw_csr(700, 640, 5, seed=17),
                           hp.SpmvConfig(**CFGS[kind]), device="cpu")
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.random(sd.num_cols).astype(np.float32))
    y_t = torch.from_numpy(rng.standard_normal(sd.num_rows).astype(
        np.float32))

    def loss():
        r = sd(x) - y_t
        return 0.5 * torch.dot(r, r)

    np.testing.assert_array_equal(sd.values(), sd.values_T())
    l_prev = float(loss().detach())
    for _ in range(4):
        sd.zero_grad()
        loss().backward()
        sd.sgd_step(0.005)
        np.testing.assert_array_equal(sd.values(), sd.values_T())
    assert float(loss().detach()) < l_prev
    pad = sd.clean(sd.vA.detach(), sd.vT.detach())[0][sd.maskA == 0]
    assert (pad == 0).all()


def test_stream_values_round_trip():
    m = hp.uniform_sparse_csr(300, 280, 4, seed=5)
    sd = hp.StreamDiffSpmv(m, hp.SpmvConfig(**CFGS["chain"]), device="cpu")
    np.testing.assert_array_equal(sd.values(), sd.m.data)
    np.testing.assert_array_equal(sd.values_T(), sd.m.data)


def test_stream_rejects_nondiff():
    m = hp.uniform_sparse_csr(128, 128, 3, seed=1)
    with pytest.raises(ValueError):
        hp.StreamDiffSpmv(m, hp.SpmvConfig(sublanes=128, bank_blocks=1,
                                           stripes=128, dtype="fixed",
                                           two_choice=False), device="cpu")


# the four training configs on powerlaw_csr(900, 800, 6, seed=11), and a
# pack of 2 row blocks by 2 column partitions
GRAD_FAMILIES = {
    **{k: (kw, (900, 800, 6, 1.5, 11)) for k, kw in CFGS.items()},
    "multipart": (dict(sublanes=128, bank_blocks=1, stripes=32,
                       two_choice=False), (4196, 16684, 3, 1.5, 4)),
}


@pytest.mark.parametrize("kind", sorted(GRAD_FAMILIES))
def test_plain_gradstream_matches_call(kind):
    """``gradstream_tiles_plain`` against ``_gradstream_call`` in interpret
    mode on the same pack, mask, g_acc and x (random, numpy-seeded)."""
    kw, args = GRAD_FAMILIES[kind]
    cfg_p = hp.SpmvConfig(**kw)
    wr = ht.pack(ht.powerlaw_csr(*args), ht.SpmvConfig(**kw))
    wp = hp.pack(hp.powerlaw_csr(*args), cfg_p)
    op_r = ht.SpmvOperator(wr, interpret=True, variant="resident")
    op = hp.SpmvOperator(wp, device="cpu", permute_x=False)
    rng = np.random.default_rng(5)
    mask_r = (rng.random(op_r.vals.shape) < 0.7).astype(np.float32)
    g_acc = rng.standard_normal(
        (wp.n_blocks * cfg_p.sublanes, 128)).astype(np.float32)
    x = rng.standard_normal(wp.num_cols).astype(np.float32)
    ref = _gradstream_call(
        op_r.vals, op_r.idxT, jnp.asarray(mask_r), op_r.part, op_r.block,
        jnp.asarray(g_acc), jnp.asarray(x), op_r.cmap, cfg=op_r.cfg,
        n_blocks=wr.n_blocks, n_parts=wr.n_parts, interpret=True,
        tiles_per_step=op_r.tb)
    mask = torch.from_numpy(stream_from_jax(mask_r, op_r.tile_src))
    args = (op.vals, op.idxT, mask, op.tile_part, op.tile_block,
            op.class_map, torch.from_numpy(g_acc),
            build_xt(torch.from_numpy(x), cfg_p, wp.n_parts), cfg_p)
    before = _kernels.gradstream_launches
    out = wavepack_gradstream(*args)
    assert _kernels.gradstream_launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  stream_from_jax(ref, op_r.tile_src))
    np.testing.assert_array_equal(out.numpy(),
                                  gradstream_tiles_plain(*args).numpy())
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="no wavepack_gradstream kernel"):
        wavepack_gradstream(*meta)


def test_stream_from_jax_rejects_bad_tile_src():
    arr = np.zeros((3, 128, 128), np.float32)
    with pytest.raises(ValueError, match="tile_src"):
        stream_from_jax(arr, np.array([0, 0, -1]))
    np.testing.assert_array_equal(
        stream_from_jax(np.arange(3.0).repeat(128 * 128), [1, -1, 0])[:, 0, 0],
        [2.0, 0.0])
