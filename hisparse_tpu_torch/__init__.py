"""hisparse_tpu_torch — the PyTorch + CUDA port of hisparse_tpu.

The wavepack format, its packer, the packed-stream SpMV main path
(``pack`` -> ``SpmvOperator`` -> natural-order y) in the plus_times,
min_plus and max_times semirings over fp32 values and in plus_times over
bf16 and saturating Q8.24 values, SpMM and the masked (SpMSpV) call, the
training paths (``DiffSpmv``, ``StreamDiffSpmv``, ``DiffSpmm``, ``GCN``),
the graph apps (``PageRank``, ``SSSP``, ``BFS``) and the format dispatch
(``choose_format`` between wavepack, ``BcsrOperator`` and
``DenseOperator`` / ``SpmmOperator``, on the perf model and rates
measured on the card) for an NVIDIA H100.  The host layers are copies of
the JAX package's (numpy and the native C++ scheduler); the TPU's Pallas
kernels become CUDA C++ kernels (``csrc/wavepack_spmv.cu``, SpMV, SpMM
and masked SpMV; ``csrc/wavepack_gradstream.cu``; ``csrc/bcsr.cu``).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  This package imports neither JAX, ``hisparse_tpu``
nor ``ml_dtypes``: bf16 streams are carried as their uint16 bit patterns.
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
from .ops.bcsr import BcsrOperator
from .ops.dense import DenseOperator, SpmmOperator, choose_format
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
    "SpmvOperator", "spmv", "spmm", "BcsrOperator", "DenseOperator",
    "SpmmOperator", "choose_format", "DiffSpmv", "StreamDiffSpmv",
    "DiffSpmm", "GCN", "gcn_normalize", "PageRank", "SSSP", "BFS",
    "pagerank", "pagerank_reference", "sssp_reference",
]
__version__ = "0.4.0"
