"""hisparse_tpu_torch — the PyTorch + CUDA port of hisparse_tpu.

The wavepack format, its packer, the packed-stream SpMV main path
(``pack`` -> ``SpmvOperator`` -> natural-order y) in the plus_times,
min_plus and max_times semirings, SpMM and the masked (SpMSpV) call, the
training paths (``DiffSpmv``, ``StreamDiffSpmv``, ``DiffSpmm``, ``GCN``)
and the graph apps (``PageRank``, ``SSSP``, ``BFS``) for an NVIDIA H100.
The host layers are copies of the JAX package's (numpy and the native C++
scheduler); the TPU's Pallas kernels on these paths become CUDA C++
kernels (``csrc/wavepack_spmv.cu``, SpMV, SpMM and masked SpMV, and
``csrc/wavepack_gradstream.cu``).  Entry points run on the card unless
the caller asks for the CPU (``device="cpu"``).  This package imports
neither JAX nor ``hisparse_tpu``.
"""
from .config import LANES, SpmvConfig, GRAPH_CONFIG, NN_CONFIG
from .formats.csr import (CSRMatrix, load_npz, save_npz, round_dims,
                          normalize_by_outdegree, dense_csr,
                          uniform_sparse_csr, powerlaw_csr,
                          rmat_csr, block_structured_csr)
from .formats.wavepack import (Wavepack, pack, decode, save_wavepack,
                               load_wavepack)
from .interop import (wavepack_from_arrays, stream_from_jax,
                      gcn_params_from_jax)
from .ops.spmv import SpmvOperator, spmv, spmm
from .ops.autodiff import DiffSpmv
from .ops.train_stream import StreamDiffSpmv
from .models.gnn import DiffSpmm, GCN, gcn_normalize
from .models.apps import (PageRank, SSSP, BFS, pagerank, pagerank_reference,
                          sssp_reference)

__all__ = [
    "LANES", "SpmvConfig", "GRAPH_CONFIG", "NN_CONFIG",
    "CSRMatrix", "load_npz", "save_npz", "round_dims",
    "normalize_by_outdegree", "dense_csr", "uniform_sparse_csr",
    "powerlaw_csr", "rmat_csr", "block_structured_csr", "Wavepack", "pack",
    "decode", "save_wavepack", "load_wavepack", "wavepack_from_arrays",
    "stream_from_jax", "gcn_params_from_jax",
    "SpmvOperator", "spmv", "spmm", "DiffSpmv", "StreamDiffSpmv",
    "DiffSpmm", "GCN", "gcn_normalize", "PageRank", "SSSP", "BFS",
    "pagerank", "pagerank_reference", "sssp_reference",
]
__version__ = "0.3.0"
