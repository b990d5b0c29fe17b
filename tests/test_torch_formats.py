"""The port's host layers against the JAX package's on the CPU: for each of
the 12 config families of the chip parity sweep, the port's ``pack`` is
byte-equal to ``hisparse_tpu.pack``, its ``decode`` round-trips, and a
reference pack carried over by ``wavepack_from_arrays`` or by an ``.npz``
from ``hisparse_tpu.save_wavepack`` equals the port's own, and the port's
pure-Python scheduler twin emits the same bytes as its native packer."""
import dataclasses
import functools

import numpy as np
import pytest

import hisparse_tpu as ht
import hisparse_tpu_torch as hp
from hisparse_tpu.ops.golden import float_to_fixed as ht_float_to_fixed
from hisparse_tpu_torch.ops.golden import float_to_fixed as hp_float_to_fixed
from hisparse_tpu_torch.utils.bench import FAMILY_INDEX, PARITY_FAMILIES

FIELDS = ("perm", "vals", "idxT", "tile_part", "tile_block", "tile_first",
          "tile_last", "col_order", "class_map")
SCALARS = ("num_rows", "num_cols", "n_blocks", "n_parts", "nnz",
           "opt_waves")


def _matrix(pkg, float_to_fixed, i, cfg, extra):
    m = pkg.powerlaw_csr(2000, cfg.vb_cols + extra, 9, alpha=1.2,
                         seed=40 + i)
    if cfg.dtype == "fixed":
        m = dataclasses.replace(
            m, data=float_to_fixed(np.abs(m.data) / (4 * 9)))
    return m


@functools.lru_cache(maxsize=None)
def packs(name):
    """(reference matrix, reference pack, port matrix, port pack)."""
    i = FAMILY_INDEX[name]
    _, kw, extra, _ = PARITY_FAMILIES[i]
    cfg_r, cfg_p = ht.SpmvConfig(**kw), hp.SpmvConfig(**kw)
    m_r = _matrix(ht, ht_float_to_fixed, i, cfg_r, extra)
    m_p = _matrix(hp, hp_float_to_fixed, i, cfg_p, extra)
    return (m_r, ht.pack(m_r, cfg_r, split_max=16),
            m_p, hp.pack(m_p, cfg_p, split_max=16))


def _bytes(a):
    """dtype, shape and bytes of a field; the reference's bf16 values (a
    2-byte numpy dtype of ml_dtypes) compare as the uint16 bit patterns the
    port holds."""
    if a is None:
        return None
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(np.uint16)
    return (a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes())


def assert_same_pack(a, b):
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    for f in SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    for f in FIELDS:
        assert _bytes(getattr(a, f)) == _bytes(getattr(b, f)), f


def _check_pack(tmp_path, monkeypatch, m_r, wr, m_p, wp):
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(m_r, f), getattr(m_p, f))
    assert_same_pack(wr, wp)


def _check_decode(tmp_path, monkeypatch, m_r, wr, m_p, wp):
    d_p, d_r = hp.decode(wp), ht.decode(wr)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(d_p, f), getattr(d_r, f))
    A = m_p.to_scipy().astype(np.float64)
    D = abs(A - d_p.to_scipy().astype(np.float64))
    cfg = wp.config
    # the stream rounds values: bf16 to 7 mantissa bits (2^-8 relative),
    # steal_mantissa clears the low 7 of fp32's 23 (< 2^-16 relative);
    # each bound is doubled for the order duplicate entries sum in.  fp32
    # otherwise differs only in that order
    rel = (2.0 ** -7 if cfg.dtype == "bf16"
           else 2.0 ** -15 if cfg.steal_mantissa
           else 0.0 if cfg.dtype == "fixed" else 1e-6)
    assert D.max() <= rel * max(abs(A).max(), 1.0)


def _check_from_arrays(tmp_path, monkeypatch, m_r, wr, m_p, wp):
    assert_same_pack(hp.wavepack_from_arrays(**vars(wr)), wp)


def _check_npz(tmp_path, monkeypatch, m_r, wr, m_p, wp):
    path = tmp_path / "pack.npz"
    ht.save_wavepack(path, wr)
    assert_same_pack(hp.load_wavepack(path), wp)


def _check_python_twin(tmp_path, monkeypatch, m_r, wr, m_p, wp):
    from hisparse_tpu_torch.formats import native
    monkeypatch.setattr(native, "pack_full", lambda *a, **k: None)
    assert_same_pack(hp.pack(m_p, wp.config, split_max=16), wp)


CHECKS = {"pack": _check_pack, "decode": _check_decode,
          "from_arrays": _check_from_arrays, "npz": _check_npz,
          "python_twin": _check_python_twin}


@pytest.mark.parametrize("check", list(CHECKS))
@pytest.mark.parametrize("name", [f[0] for f in PARITY_FAMILIES])
def test_port_formats_match_reference(name, check, tmp_path, monkeypatch):
    CHECKS[check](tmp_path, monkeypatch, *packs(name))


def test_col_order_pack_matches_reference():
    """A pack with a degree column order (the main path's col_order)."""
    kw = dict(sublanes=128, bank_blocks=2, stripes=128, block_major=True,
              classes_per_group=2, steal_mantissa=True)
    m_r = ht.powerlaw_csr(600, 30000, 8, alpha=1.3, seed=31)
    m_p = hp.powerlaw_csr(600, 30000, 8, alpha=1.3, seed=31)
    wr = ht.pack(m_r, ht.SpmvConfig(**kw), split_max=16, col_order="degree")
    wp = hp.pack(m_p, hp.SpmvConfig(**kw), split_max=16, col_order="degree")
    assert wp.col_order is not None
    assert_same_pack(wr, wp)


def test_bf16_bits_match_ml_dtypes():
    """The port's float32 -> bf16 conversion (round to nearest even from
    the float32 bits, in numpy) gives ml_dtypes' bits on edge values: ties
    either way, values just off a tie, the largest finite float32 and the
    largest bf16 (rounding up to inf), +-inf, NaNs with payloads and signs,
    subnormals (ties included), signed zeros; and on a million random bit
    patterns.  ``bf16_bits_to_f32`` widens back exactly."""
    import ml_dtypes
    from hisparse_tpu_torch.formats.wavepack import (bf16_bits_to_f32,
                                                     f32_to_bf16_bits)
    edge = np.array([
        0x3F808000, 0x3F818000, 0x3F808001, 0x3F817FFF, 0xBF808000,
        0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7FFFFF,
        0x7F800000, 0xFF800000,
        0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800001, 0xFFC12345,
        0x7FFFFFFF, 0xFF800001,
        0x00000001, 0x00008000, 0x00018000, 0x00007FFF, 0x007FFFFF,
        0x80008000, 0x80018000, 0x00800000,
        0x00000000, 0x80000000], np.uint32)
    rand = np.random.default_rng(0).integers(0, 1 << 32, 1 << 20,
                                             dtype=np.uint64)
    for bits in (edge, rand.astype(np.uint32)):
        f = bits.view(np.float32)
        with np.errstate(invalid="ignore"):
            ref = f.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(f32_to_bf16_bits(f), ref)
    back = bf16_bits_to_f32(f32_to_bf16_bits(edge.view(np.float32)))
    with np.errstate(invalid="ignore"):
        ref = edge.view(np.float32).astype(ml_dtypes.bfloat16).astype(
            np.float32)
    np.testing.assert_array_equal(back.view(np.uint32),
                                  ref.view(np.uint32))


def test_port_imports_no_jax():
    """The port's modules and chip_smoke.py import neither jax,
    hisparse_tpu nor ml_dtypes: no import statement names them, and
    importing every module of the port in a fresh interpreter loads none of
    them."""
    import pathlib
    import re
    import subprocess
    import sys
    pkg = pathlib.Path(hp.__file__).parent
    root = pkg.parent
    files = sorted(pkg.rglob("*.py"))
    names = {str(p.relative_to(pkg)) for p in files}
    assert {"ops/spmv.py", "ops/autodiff.py", "ops/train_stream.py",
            "models/gnn.py", "models/apps.py", "interop.py", "ops/bcsr.py",
            "ops/dense.py", "models/perf_model.py", "models/dse.py"} <= names
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|hisparse_tpu|ml_dtypes)(\.|\s|$)", re.M)
    bad = [str(p) for p in files + [root / "chip_smoke.py"]
           if pat.search(p.read_text())]
    assert bad == []
    mods = [".".join(("hisparse_tpu_torch",) + p.relative_to(pkg).with_suffix(
        "").parts).removesuffix(".__init__") for p in files]
    code = ("import importlib, sys\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'hisparse_tpu',\n"
            "                                    'ml_dtypes')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
