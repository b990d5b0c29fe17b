"""Carry the JAX package's packed state into the port.

Both packages share the wavepack format byte for byte, so a pack made by
either runs in the port unchanged:

  * :func:`wavepack_from_arrays` builds the port's :class:`Wavepack` from a
    reference pack's fields (numpy arrays and ints; the config may be any
    object with the :class:`SpmvConfig` fields, such as
    ``hisparse_tpu.SpmvConfig``); bf16 values become their uint16 bit
    patterns;
  * ``formats.wavepack.load_wavepack`` (also ``hisparse_tpu_torch.
    load_wavepack``) reads an ``.npz`` written by
    ``hisparse_tpu.save_wavepack``: the file layout is the same.

Training state crosses too:

  * :func:`stream_from_jax` turns an array in a JAX operator's stream
    layout (``StreamDiffSpmv``'s ``vA`` / ``vT``, its masks, its gradient
    streams) into the port's, which has no pad tiles;
  * :func:`gcn_params_from_jax` turns a JAX GCN parameter list into the
    port's (``GCN.load_params`` takes it);
  * :func:`sharded_values_from_jax` turns the JAX mesh trainers' stacked
    per-device state (``ShardedDiffSpmv``'s ``(n_devices, nnz_max)``
    values, ``ShardedStreamDiffSpmv``'s ``(n_devices, T, S, 128)``
    streams and their gradients) into the port's one tensor a shard.

This module imports neither JAX nor the JAX package: it takes numpy
arrays (``np.asarray`` of a JAX array is one).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    if cfg.dtype == "bf16" and "vals" in arrays:
        # the reference holds bf16 values in a 2-byte numpy dtype of its
        # own; the port carries their bit patterns
        arrays["vals"] = arrays["vals"].view(np.uint16)
    return Wavepack(config=cfg, **arrays)


def stream_from_jax(arr, tile_src) -> np.ndarray:
    """A JAX operator's (T_jax, S, 128) stream-layout array -> the port's
    (T, S, 128): real tile k of the port is the JAX row j with
    ``tile_src[j] == k`` (``hisparse_tpu.SpmvOperator.tile_src``), and pad
    tiles (``tile_src == -1``) are dropped.  A flat array of T_jax*S*128
    elements is taken as well."""
    tile_src = np.asarray(tile_src)
    arr = np.asarray(arr).reshape(tile_src.shape[0], -1)
    real = tile_src >= 0
    T = int(real.sum())
    if not np.array_equal(np.sort(tile_src[real]), np.arange(T)):
        raise ValueError("tile_src must map its real rows onto 0..T-1 "
                         "once each")
    out = np.empty((T, arr.shape[1]), arr.dtype)
    out[tile_src[real]] = arr[real]
    return out.reshape(T, -1, 128)


def gcn_params_from_jax(params):
    """A JAX GCN parameter list ``[{'w', 'b'}, ...]`` (numpy or JAX
    arrays) -> the port's, float32 CPU tensors (``GCN.load_params``)."""
    return [{k: torch.from_numpy(np.array(p[k], np.float32))
             for k in ("w", "b")} for p in params]


def sharded_values_from_jax(stacked, lengths) -> list:
    """A JAX mesh trainer's stacked per-device array -> one float32 CPU
    tensor a shard: row d of ``stacked`` cut to its first ``lengths[d]``
    entries along its first axis.  The JAX package pads its stacks to the
    largest shard; the port's shards are not padded.  For CSR-order values
    (``(n_devices, nnz_max)``) the lengths are the shards' nonzeros
    (``nnz_shard``), for streams (``(n_devices, T, S, 128)``) their tile
    counts."""
    a = np.asarray(stacked, np.float32)
    if len(lengths) != a.shape[0]:
        raise ValueError(f"{a.shape[0]} shards stacked, {len(lengths)} "
                         "lengths given")
    return [torch.from_numpy(np.array(a[d, :n]))
            for d, n in enumerate(lengths)]
