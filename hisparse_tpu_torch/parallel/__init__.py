"""Sharding over a device mesh: inference and multi-host (``mesh``),
training (``train``), GNN (``gnn``) and graph-app (``apps``) forms.

One process drives every shard; a :class:`Mesh` is a grid of
``torch.device`` with axis names (four shards may share ``cuda:0``)."""
from .apps import ShardedBFS, ShardedPageRank, ShardedSSSP
from .gnn import ShardedDiffSpmm, ShardedGCN
from .mesh import (Mesh, ShardedSpmv, ShardedSpmv2D, ShardedSpmvMultiHost,
                   all_gather, all_reduce)
from .train import ShardedDiffSpmv, ShardedStreamDiffSpmv

__all__ = ["Mesh", "all_gather", "all_reduce",
           "ShardedSpmv", "ShardedSpmv2D", "ShardedSpmvMultiHost",
           "ShardedDiffSpmv", "ShardedStreamDiffSpmv",
           "ShardedDiffSpmm", "ShardedGCN",
           "ShardedPageRank", "ShardedSSSP", "ShardedBFS"]
