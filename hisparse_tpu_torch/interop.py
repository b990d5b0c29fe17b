"""Carry the JAX package's packed state into the port.

Both packages share the wavepack format byte for byte, so a pack made by
either runs in the port unchanged:

  * :func:`wavepack_from_arrays` builds the port's :class:`Wavepack` from a
    reference pack's fields (numpy arrays and ints; the config may be any
    object with the :class:`SpmvConfig` fields, such as
    ``hisparse_tpu.SpmvConfig``);
  * ``formats.wavepack.load_wavepack`` (also ``hisparse_tpu_torch.
    load_wavepack``) reads an ``.npz`` written by
    ``hisparse_tpu.save_wavepack``: the file layout is the same.

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .config import SpmvConfig
from .formats.wavepack import Wavepack


def wavepack_from_arrays(config, **fields) -> Wavepack:
    """The port's Wavepack from a reference pack's fields, e.g.
    ``wavepack_from_arrays(**vars(wp_ref))``."""
    cfg = SpmvConfig(**{f.name: getattr(config, f.name)
                        for f in dataclasses.fields(SpmvConfig)})
    known = {f.name for f in dataclasses.fields(Wavepack)} - {"config"}
    unknown = set(fields) - known
    if unknown:
        raise TypeError(f"unknown Wavepack fields: {sorted(unknown)}")
    arrays = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in fields.items()}
    return Wavepack(config=cfg, **arrays)
