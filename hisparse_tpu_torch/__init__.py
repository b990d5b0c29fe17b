"""hisparse_tpu_torch — the PyTorch + CUDA port of hisparse_tpu.

The wavepack format, its packer and the packed-stream SpMV main path
(``pack`` -> ``SpmvOperator`` -> natural-order y) for an NVIDIA H100.  The
host layers are copies of the JAX package's (numpy and the native C++
scheduler); the TPU's Pallas SpMV kernels become one CUDA C++ kernel
(``csrc/wavepack_spmv.cu``).  This package imports neither JAX nor
``hisparse_tpu``.
"""
from .config import LANES, SpmvConfig, GRAPH_CONFIG, NN_CONFIG
from .formats.csr import (CSRMatrix, load_npz, save_npz, round_dims,
                          normalize_by_outdegree, dense_csr,
                          uniform_sparse_csr, powerlaw_csr,
                          rmat_csr, block_structured_csr)
from .formats.wavepack import (Wavepack, pack, decode, save_wavepack,
                               load_wavepack)
from .interop import wavepack_from_arrays
from .ops.spmv import SpmvOperator, spmv

__all__ = [
    "LANES", "SpmvConfig", "GRAPH_CONFIG", "NN_CONFIG",
    "CSRMatrix", "load_npz", "save_npz", "round_dims",
    "normalize_by_outdegree", "dense_csr", "uniform_sparse_csr",
    "powerlaw_csr", "rmat_csr", "block_structured_csr", "Wavepack", "pack",
    "decode", "save_wavepack", "load_wavepack", "wavepack_from_arrays",
    "SpmvOperator", "spmv",
]
__version__ = "0.1.0"
