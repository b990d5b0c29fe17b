"""Faults of the ``train`` driver's cells: the GCN's training step through
``DiffSpmm`` and ``torch.optim.Adam`` (``faults.py``)."""
from __future__ import annotations

import torch

from hisparse_tpu_torch.models import gnn
from hisparse_tpu_torch.ops.spmv import SPMM_MAX_F


def no_step(monkeypatch) -> None:
    """The optimizer's step skipped: the parameters stay as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_backward(monkeypatch) -> None:
    """Every other feature chunk of each backward SpMM left out."""
    orig = gnn._SpmmFn.backward

    def backward(ctx, G):
        G = G.clone()
        for f0 in range(SPMM_MAX_F, G.shape[1], 2 * SPMM_MAX_F):
            G[:, f0:f0 + SPMM_MAX_F] = 0
        if G.shape[1] <= SPMM_MAX_F:
            G[:, ::2] = 0
        return orig(ctx, G)
    monkeypatch.setattr(gnn._SpmmFn, "backward", staticmethod(backward))


def bf16_backward(monkeypatch) -> None:
    """Each backward SpMM's input rounded to bfloat16, the forward's not."""
    orig = gnn._SpmmTFn.forward

    def forward(ctx, G, agg):
        return orig(ctx, G.to(torch.bfloat16).to(torch.float32), agg)
    monkeypatch.setattr(gnn._SpmmTFn, "forward", staticmethod(forward))


def last_chunk(monkeypatch) -> None:
    """The last feature chunk of each forward SpMM left out."""
    orig = gnn._SpmmFn.forward

    def forward(ctx, X, agg):
        Y = orig(ctx, X, agg).clone()
        Y[:, (X.shape[1] - 1) // SPMM_MAX_F * SPMM_MAX_F:] = 0
        return Y
    monkeypatch.setattr(gnn._SpmmFn, "forward", staticmethod(forward))


def masks_unapplied(monkeypatch) -> None:
    """The dropout masks drawn but not applied."""
    def dropout(h, p, generator):
        torch.rand(h.shape, generator=generator, dtype=torch.float32,
                   device=h.device)
        return h
    monkeypatch.setattr(gnn, "gcn_dropout", dropout)


FAULTS = [("no_step", no_step), ("half_backward", half_backward),
          ("last_chunk", last_chunk), ("masks_unapplied", masks_unapplied),
          ("bf16_backward", bf16_backward)]
