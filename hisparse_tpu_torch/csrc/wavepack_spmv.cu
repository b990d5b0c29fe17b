// Wavepack SpMV and SpMM for Hopper (sm_90a): fp32 plus_times over a
// packed tile stream, for one vector (SpMV) or up to kMaxF feature columns
// (SpMM) in one pass.
//
// Replaces four TPU kernels, hisparse_tpu/ops/spmv.py: _resident_kernel and
// _paged_kernel (with their helpers _route_x, _tile_routed and _tile_body),
// the serving and training SpMV; and _resident_spmm_kernel and
// _paged_spmm_kernel (called through _spmm_call), the aggregation of the
// GNN path (models/gnn.py).  Resident versus paged was a VMEM budget of
// the TPU; here one kernel serves single- and multi-partition packs.  SpMV
// is SpMM at one feature: one kernel body, instantiated at kF = 1 for SpMV
// and at kF = kMaxF for SpMM.
//
// What it computes.  For every feature f < F and accumulator slot
// (b, s, l) of row block b:
//
//   acc[f, b, s, l] = sum over the tiles t of b's run, in stream order, of
//                     vals'[t, s, l] * XT[part[t], f, blk, src, h]
//
// with vals' the value cleaned of its stolen bits and (blk, src, h) the
// routing of slot (s, l) of tile t (route.cuh).  XT is the F-stacked
// bank-block layout (n_parts, F, CT, 128, 128) of build_xt_multi
// (ops/spmv.py), the layout of the TPU kernels; at F = 1 it is build_xt's
// (n_parts, CT, 128, 128).
//
// Mapping.  One thread per accumulator slot: a CTA owns kRows consecutive
// sublanes of one row block (kRows * 128 threads, lane l fastest) and walks
// that block's contiguous tile run.  No atomics, the same result every run,
// and each slot sums its terms in the TPU's sequential grid order.  For
// each tile the CTA first stages the kRows columns of the transposed idx
// words it needs (128 x kRows) in shared memory, so the crossbar lookup
// idx[src][s] is a shared-memory read.  The thread routes its slot once per
// tile and keeps F accumulators in registers, so each feature sums its
// terms in stream order and the result does not depend on how the caller
// chunks the features.  Multiply and add are rounded separately
// (__fmul_rn, __fadd_rn), as the plain PyTorch versions do.
//
// What bounds it.  Every slot of the stream is read once for all F
// features: 4 B of value plus 2 B (idx16) or 4 B of idx word, 6 B/slot
// with idx16.  At F = 1 XT and the tile metadata are small and stay in L2,
// and the output is 4 B per slot of one tile, so the stream's bytes over
// HBM bandwidth bound the kernel.  The design reads values coalesced (128
// consecutive floats per sublane) and reads each idx word once per CTA;
// its idx loads are kRows-element runs, which neighbouring CTAs of the
// same block complete in L2.  It does not yet overlap a tile's loads with
// the previous tile's compute (cp.async / TMA staging is later work).
// Each further feature adds one 4 B gather from XT, which is F * CT * 64 KB
// a partition and stays in L2 at the suite's sizes (8 MB at F = 16,
// CT = 8): at F = 16 the gathers, not the stream, set the time.  Staging a
// tile's XT slice in shared memory is later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "route.cuh"

namespace {

using namespace wavepack;

constexpr int kMaxF = 16;                // features in registers

struct Params {
  const uint32_t* vals;                  // (T, S, 128) fp32 bits
  const void* idxT;                      // (T, S, 128) int16 or int32
  const int32_t* tile_part;              // (T,)
  const int32_t* cmap;                   // (T, S/128, K), block-major only
  const int32_t* run_start;              // (n_blocks,)
  const int32_t* run_end;                // (n_blocks,)
  const float* xt;                       // (n_parts, F, CT, 128, 128)
  float* out;                            // (F, n_blocks * S, 128)
  int n_blocks, S, n_ops, K, CT, F;
};

// kF accumulators a thread, of which the first p.F are live (p.F == 1
// when kF == 1, and the SpMV code is then free of the feature loop).
template <typename IdxT, bool kSteal, bool kBlockMajor, int kF>
__global__ void __launch_bounds__(kThreads)
wavepack_kernel(const Params p) {
  const uint32_t* __restrict__ vals = p.vals;
  const IdxT* __restrict__ idxT = static_cast<const IdxT*>(p.idxT);
  const int32_t* __restrict__ tile_part = p.tile_part;
  const float* __restrict__ xt = p.xt;
  const int S = p.S;
  const int F = kF == 1 ? 1 : p.F;
  const int chunks = S / kRows;
  const int b = blockIdx.x / chunks;
  const int s0 = (blockIdx.x % chunks) * kRows;
  const int rr = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int s = s0 + rr;
  const int G = S / kLanes;
  const int64_t page = static_cast<int64_t>(p.CT) * kPage;

  __shared__ int32_t sidx[kLanes][kRows];
  float acc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = 0.0f;
  const int t_end = p.run_end[b];
  for (int t = p.run_start[b]; t < t_end; ++t) {
    const int64_t tile = static_cast<int64_t>(t) * S * kLanes;
    stage_idx(sidx, idxT, tile, s0);
    __syncthreads();
    uint32_t vbits = vals[tile + static_cast<int64_t>(s) * kLanes + l];
    const int off = route<kSteal, kBlockMajor>(vbits, sidx, rr, l, t, s0,
                                               p.cmap, G, p.K, p.n_ops);
    const float v = __uint_as_float(vbits);
    const float* __restrict__ xf =
        xt + static_cast<int64_t>(tile_part[t]) * F * page + off;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      if (f < F) acc[f] = __fadd_rn(acc[f], __fmul_rn(v, xf[f * page]));
    }
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(p.n_blocks) * S * kLanes;
  float* out = p.out + (static_cast<int64_t>(b) * S + s) * kLanes + l;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f < F) out[f * stride] = acc[f];
  }
}

template <int kF>
void launch(const Params& p, bool idx16, bool steal, bool block_major,
            cudaStream_t st) {
  const dim3 grid(p.n_blocks * (p.S / kRows));
  dispatch(idx16, steal, block_major, [&](auto idx, auto st_, auto bm) {
    wavepack_kernel<decltype(idx), decltype(st_)::value, decltype(bm)::value,
                    kF><<<grid, kThreads, 0, st>>>(p);
  });
}

}  // namespace

// C entry points, loaded with ctypes (ops/_kernels.py).  Shapes: vals and
// idxT (T, S, 128); tile_part (T,); cmap (T, S/128, K) or null; run_start
// and run_end (n_blocks,).  Both return cudaGetLastError() after the
// launch.
//
// SpMV: xt (n_parts, CT, 128, 128); out (n_blocks*S, 128).
extern "C" int wavepack_spmv_f32(const void* vals, const void* idxT,
                                 int idx16, int steal, int block_major,
                                 const void* tile_part, const void* cmap,
                                 const void* run_start, const void* run_end,
                                 const void* xt, void* out, int n_blocks,
                                 int S, int n_ops, int K, int CT,
                                 void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(vals), idxT,
                 static_cast<const int32_t*>(tile_part),
                 static_cast<const int32_t*>(cmap),
                 static_cast<const int32_t*>(run_start),
                 static_cast<const int32_t*>(run_end),
                 static_cast<const float*>(xt), static_cast<float*>(out),
                 n_blocks, S, n_ops, K, CT, 1};
  launch<1>(p, idx16, steal, block_major, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// SpMM: xt (n_parts, F, CT, 128, 128); out (F, n_blocks*S, 128),
// 1 <= F <= 16.
extern "C" int wavepack_spmm_f32(const void* vals, const void* idxT,
                                 int idx16, int steal, int block_major,
                                 const void* tile_part, const void* cmap,
                                 const void* run_start, const void* run_end,
                                 const void* xt, void* out, int n_blocks,
                                 int S, int n_ops, int K, int CT, int F,
                                 void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1 || F < 1 || F > kMaxF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(vals), idxT,
                 static_cast<const int32_t*>(tile_part),
                 static_cast<const int32_t*>(cmap),
                 static_cast<const int32_t*>(run_start),
                 static_cast<const int32_t*>(run_end),
                 static_cast<const float*>(xt), static_cast<float*>(out),
                 n_blocks, S, n_ops, K, CT, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 1) {
    launch<1>(p, idx16, steal, block_major, st);
  } else {
    launch<kMaxF>(p, idx16, steal, block_major, st);
  }
  return static_cast<int>(cudaGetLastError());
}
