"""Faults of the ``queries`` driver's cells: ``SSSP.run``, dense and
masked (``faults.py``)."""
from __future__ import annotations

import torch
from faults import half_the_slots

import hisparse_tpu_torch.ops.spmv as spmv_mod
from hisparse_tpu_torch.models import apps
from hisparse_tpu_torch.ops.spmv import IDENTITY


def altered(monkeypatch) -> None:
    """One reached vertex's distance altered where it is produced."""
    orig = apps.SSSP.run

    def run(self, *a, **kw):
        d = orig(self, *a, **kw).clone()
        reached = torch.nonzero(torch.isfinite(d) & (d > 0)).flatten()
        d[reached[len(reached) // 2]] *= 1.01
        return d
    monkeypatch.setattr(apps.SSSP, "run", run)


def half(monkeypatch) -> None:
    """Half of every tile's slots left out of the dense and the masked
    kernel."""
    for name in ("wavepack_spmv", "wavepack_spmv_masked"):
        monkeypatch.setattr(spmv_mod, name,
                            half_the_slots(getattr(spmv_mod, name)))


def unchanged(monkeypatch) -> None:
    """Each iteration returns its state unchanged: the dense step says
    nothing fell, the masked product is the semiring's identity."""
    monkeypatch.setattr(apps.SSSP, "step",
                        lambda self, x: (x, torch.tensor(False)))

    def identity(self, x, active):
        return torch.full((self.n,), IDENTITY[self.wp.config.semiring],
                          device=x.device), 0
    monkeypatch.setattr(apps.SSSP, "spmv_masked", identity)


FAULTS = [("altered", altered), ("half", half), ("unchanged", unchanged)]
