"""Faults of the ``calls`` driver's cells: ``SpmvOperator.forward`` and
``matmul`` (``faults.py``)."""
from __future__ import annotations

from faults import half_the_slots

import hisparse_tpu_torch.ops.spmv as spmv_mod
from hisparse_tpu_torch.ops.spmv import SpmvOperator

ENTRIES = ("forward", "matmul")


def altered(monkeypatch) -> None:
    """One output value altered where it is produced."""
    for name in ENTRIES:
        orig = getattr(SpmvOperator, name)

        def call(self, *a, _orig=orig, **kw):
            y = _orig(self, *a, **kw).clone()
            y.view(-1)[y.numel() // 2] += 1.0
            return y
        monkeypatch.setattr(SpmvOperator, name, call)


def half(monkeypatch) -> None:
    """Half of every tile's slots left out of the kernels."""
    for name in ("wavepack_spmv", "wavepack_spmm"):
        monkeypatch.setattr(spmv_mod, name,
                            half_the_slots(getattr(spmv_mod, name)))


def unchanged(monkeypatch) -> None:
    """Each call returns the last call's output: state left unchanged."""
    for name in ENTRIES:
        orig = getattr(SpmvOperator, name)
        last = {}

        def stale(self, *a, _orig=orig, _last=last, **kw):
            y = _orig(self, *a, **kw)
            prev = _last.get("y", y)
            _last["y"] = y
            return prev
        monkeypatch.setattr(SpmvOperator, name, stale)


FAULTS = [("altered", altered), ("half", half), ("unchanged", unchanged)]
