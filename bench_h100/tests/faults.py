"""The faults the correctness tests plant under a cell's timed path, found
by the cell's driver: ``faults_<driver>.py`` beside this file holds
``FAULTS``, a list of ``(name, plant)``, each ``plant(monkeypatch)``
breaking the program where that driver's requests go.  A driver with no
such file is refused, so that no cell goes unguarded."""
from __future__ import annotations

import importlib.util
import os

import torch

from bench_h100 import harness
from hisparse_tpu_torch.ops.spmv import IDENTITY

HERE = os.path.dirname(os.path.abspath(__file__))


def faults_of(driver: str) -> list:
    """``FAULTS`` of ``faults_<driver>.py``; ``LookupError`` without it."""
    path = os.path.join(HERE, f"faults_{driver}.py")
    if not os.path.exists(path):
        raise LookupError(f"driver {driver!r} has no faults file "
                          f"faults_{driver}.py: its cells go unguarded")
    spec = importlib.util.spec_from_file_location(f"faults_{driver}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


def cases(manifest: dict, bench: str = harness.BENCH) -> list:
    """``(workload, fault name, plant)`` for every cell and each fault of
    its driver."""
    out = []
    for w in manifest["workloads"]:
        driver = harness.Spec(w["name"], manifest, bench).traffic["driver"]
        out += [(w["name"], name, plant) for name, plant in faults_of(driver)]
    return out


def half_the_slots(fn):
    """The stream kernel ``fn`` with half of every tile's slots left out:
    they hold the semiring's identity, as if never streamed."""
    def broken(vals, idxT, *args, **kw):
        cfg = next(a for a in args if hasattr(a, "semiring"))
        v = vals.clone()
        flat = v.view(v.shape[0], -1)
        flat[:, ::2] = (0 if v.dtype != torch.float32
                        else IDENTITY[cfg.semiring])
        return fn(v, idxT, *args, **kw)
    return broken
