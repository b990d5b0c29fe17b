// Wavepack SpMV, SpMM and masked SpMV for Hopper (sm_90a): fp32 semiring
// products over a packed tile stream, for one vector (SpMV), up to kMaxF
// feature columns (SpMM) in one pass, or one vector over a selected subset
// of the tiles (the masked SpMSpV analog).
//
// Replaces six TPU kernels, hisparse_tpu/ops/spmv.py: _resident_kernel and
// _paged_kernel (with their helpers _acc_init, _route_x, _tile_routed and
// _tile_body), the serving and training SpMV and the graph apps' dense
// steps; _resident_spmm_kernel and _paged_spmm_kernel (called through
// _spmm_call), the aggregation of the GNN path (models/gnn.py); and
// _resident_masked_kernel and _paged_masked_kernel (called through
// _spmv_masked_call), the sparse-frontier steps of SSSP and BFS
// (models/apps.py).  Resident versus paged was a VMEM budget of the TPU;
// here one kernel serves single- and multi-partition packs.  SpMV is SpMM
// at one feature and the masked SpMV is SpMV over a list of tiles: one
// kernel body, instantiated at kF = 1 for SpMV, at kF = kMaxF for SpMM and
// with kMasked for the masked call.
//
// What it computes.  For every feature f < F and accumulator slot
// (b, s, l) of row block b:
//
//   acc[f, b, s, l] = (+) over the tiles t of b's run, in run order, of
//                     vals'[t, s, l] (x) XT[part[t], f, blk, src, h]
//
// from the semiring's identity, with vals' the value cleaned of its stolen
// bits and (blk, src, h) the routing of slot (s, l) of tile t (route.cuh).
// The semiring (kSr) is plus_times (acc + v*x, from 0), min_plus
// (min(acc, v + x), from +inf) or max_times (max(acc, v*x), from -inf);
// each operation is rounded once (__fmul_rn, __fadd_rn), as the plain
// PyTorch versions do.  min and max take the new term when it is smaller
// (larger) or NaN, so a NaN propagates as torch.minimum and jnp.minimum
// propagate it; fminf and fmaxf would drop it.  A block's run is its
// contiguous tile run of the stream, or with kMasked its run into the
// selected tile ids (tile_ids[i] for i in the run); a block without tiles
// comes out at the identity.  XT is the F-stacked bank-block layout
// (n_parts, F, CT, 128, 128) of build_xt_multi (ops/spmv.py), the layout
// of the TPU kernels; at F = 1 it is build_xt's (n_parts, CT, 128, 128).
//
// Mapping.  One thread per accumulator slot: a CTA owns kRows consecutive
// sublanes of one row block (kRows * 128 threads, lane l fastest) and walks
// that block's run.  No atomics, the same result every run, and each slot
// folds its terms in the TPU's sequential grid order.  For each tile the
// CTA first stages the kRows columns of the transposed idx words it needs
// (128 x kRows) in shared memory, so the crossbar lookup idx[src][s] is a
// shared-memory read.  The thread routes its slot once per tile and keeps
// F accumulators in registers, so each feature folds its terms in stream
// order and the result does not depend on how the caller chunks the
// features.  The masked call reads only the selected tiles: a skipped tile
// costs no device-memory traffic.
//
// What bounds it.  Every slot of the stream (or of the selected tiles) is
// read once for all F features: 4 B of value plus 2 B (idx16) or 4 B of
// idx word, 6 B/slot with idx16.  At F = 1 XT and the tile metadata are
// small and stay in L2, and the output is 4 B per slot of one tile, so the
// stream's bytes over HBM bandwidth bound the kernel.  The design reads
// values coalesced (128 consecutive floats per sublane) and reads each idx
// word once per CTA; its idx loads are kRows-element runs, which
// neighbouring CTAs of the same block complete in L2.  It does not yet
// overlap a tile's loads with the previous tile's compute (cp.async / TMA
// staging is later work), and a pack with few row blocks and long runs (the
// SSSP pokec pack: 50 blocks, about 200 mostly empty tiles a block) gives
// few CTAs long walks.  Each further feature adds one 4 B gather from XT,
// which is F * CT * 64 KB a partition and stays in L2 at the suite's sizes
// (8 MB at F = 16, CT = 8): at F = 16 the gathers, not the stream, set the
// time.  Staging a tile's XT slice in shared memory is later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "route.cuh"

namespace {

using namespace wavepack;

constexpr int kMaxF = 16;                // features in registers

// the semiring of kernel template argument kSr; the values are the ones
// ops/_kernels.py passes
constexpr int kPlusTimes = 0;
constexpr int kMinPlus = 1;
constexpr int kMaxTimes = 2;

struct Params {
  const uint32_t* vals;                  // (T, S, 128) fp32 bits
  const void* idxT;                      // (T, S, 128) int16 or int32
  const int32_t* tile_ids;               // (n_sel,), masked only
  const int32_t* tile_part;              // (T,)
  const int32_t* cmap;                   // (T, S/128, K), block-major only
  const int32_t* run_start;              // (n_blocks,)
  const int32_t* run_end;                // (n_blocks,)
  const float* xt;                       // (n_parts, F, CT, 128, 128)
  float* out;                            // (F, n_blocks * S, 128)
  int n_blocks, S, n_ops, K, CT, F;
};

template <int kSr>
__device__ __forceinline__ float identity() {
  return kSr == kMinPlus ? __int_as_float(0x7f800000)      // +inf
         : kSr == kMaxTimes ? __int_as_float(0xff800000)   // -inf
                            : 0.0f;
}

// acc (+) v (x) x, each operation rounded once; min and max keep a NaN
template <int kSr>
__device__ __forceinline__ float combine(float acc, float v, float x) {
  if (kSr == kMinPlus) {
    const float t = __fadd_rn(v, x);
    return (t < acc || isnan(t)) ? t : acc;
  }
  if (kSr == kMaxTimes) {
    const float t = __fmul_rn(v, x);
    return (t > acc || isnan(t)) ? t : acc;
  }
  return __fadd_rn(acc, __fmul_rn(v, x));
}

// kF accumulators a thread, of which the first p.F are live (p.F == 1
// when kF == 1, and the SpMV code is then free of the feature loop).
template <typename IdxT, bool kSteal, bool kBlockMajor, int kF, int kSr,
          bool kMasked>
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
  for (int f = 0; f < kF; ++f) acc[f] = identity<kSr>();
  const int i_end = p.run_end[b];
  for (int i = p.run_start[b]; i < i_end; ++i) {
    const int t = kMasked ? p.tile_ids[i] : i;
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
      if (f < F) acc[f] = combine<kSr>(acc[f], v, xf[f * page]);
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

// Launches the instantiation for the run-time semiring and pack flags;
// returns false, launching nothing, for a combination the packer refuses
// (config.py): min_plus with steal_mantissa (or idx16, which needs it),
// idx16 without steal_mantissa, an unknown semiring.
template <int kF, bool kMasked>
bool launch(const Params& p, int semiring, bool idx16, bool steal,
            bool block_major, cudaStream_t st) {
  const dim3 grid(p.n_blocks * (p.S / kRows));
  bool ok = semiring == kPlusTimes || semiring == kMaxTimes ||
            (semiring == kMinPlus && !steal);
  ok = ok && dispatch(idx16, steal, block_major,
                      [&](auto idx, auto st_, auto bm) {
    using Idx = decltype(idx);
    constexpr bool kSt = decltype(st_)::value;
    constexpr bool kBm = decltype(bm)::value;
    if (semiring == kPlusTimes) {
      wavepack_kernel<Idx, kSt, kBm, kF, kPlusTimes, kMasked>
          <<<grid, kThreads, 0, st>>>(p);
    } else if (semiring == kMaxTimes) {
      wavepack_kernel<Idx, kSt, kBm, kF, kMaxTimes, kMasked>
          <<<grid, kThreads, 0, st>>>(p);
    } else if constexpr (!kSt) {
      wavepack_kernel<Idx, kSt, kBm, kF, kMinPlus, kMasked>
          <<<grid, kThreads, 0, st>>>(p);
    }
  });
  return ok;
}

Params make_params(const void* vals, const void* idxT, const void* tile_ids,
                   const void* tile_part, const void* cmap,
                   const void* run_start, const void* run_end,
                   const void* xt, void* out, int n_blocks, int S, int n_ops,
                   int K, int CT, int F) {
  return Params{static_cast<const uint32_t*>(vals), idxT,
                static_cast<const int32_t*>(tile_ids),
                static_cast<const int32_t*>(tile_part),
                static_cast<const int32_t*>(cmap),
                static_cast<const int32_t*>(run_start),
                static_cast<const int32_t*>(run_end),
                static_cast<const float*>(xt), static_cast<float*>(out),
                n_blocks, S, n_ops, K, CT, F};
}

int result(bool ok) {
  return ok ? static_cast<int>(cudaGetLastError())
            : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points, loaded with ctypes (ops/_kernels.py).  Shapes: vals and
// idxT (T, S, 128); tile_part (T,); cmap (T, S/128, K) or null; run_start
// and run_end (n_blocks,).  semiring: 0 plus_times, 1 min_plus, 2
// max_times.  Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, launching nothing, for operands it refuses.
//
// SpMV: xt (n_parts, CT, 128, 128); out (n_blocks*S, 128).
extern "C" int wavepack_spmv_f32(const void* vals, const void* idxT,
                                 int idx16, int steal, int block_major,
                                 int semiring, const void* tile_part,
                                 const void* cmap, const void* run_start,
                                 const void* run_end, const void* xt,
                                 void* out, int n_blocks, int S, int n_ops,
                                 int K, int CT, void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, nullptr, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1);
  return result(launch<1, false>(p, semiring, idx16, steal, block_major,
                                 static_cast<cudaStream_t>(stream)));
}

// Masked SpMV: tile_ids (n_sel,) the selected tiles in stream order;
// run_start / run_end each block's run into tile_ids; otherwise as SpMV.
extern "C" int wavepack_spmv_masked_f32(
    const void* vals, const void* idxT, int idx16, int steal,
    int block_major, int semiring, const void* tile_ids,
    const void* tile_part, const void* cmap, const void* run_start,
    const void* run_end, const void* xt, void* out, int n_blocks, int S,
    int n_ops, int K, int CT, void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, tile_ids, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1);
  return result(launch<1, true>(p, semiring, idx16, steal, block_major,
                                static_cast<cudaStream_t>(stream)));
}

// SpMM: xt (n_parts, F, CT, 128, 128); out (F, n_blocks*S, 128),
// 1 <= F <= 16.
extern "C" int wavepack_spmm_f32(const void* vals, const void* idxT,
                                 int idx16, int steal, int block_major,
                                 int semiring, const void* tile_part,
                                 const void* cmap, const void* run_start,
                                 const void* run_end, const void* xt,
                                 void* out, int n_blocks, int S, int n_ops,
                                 int K, int CT, int F, void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1 || F < 1 || F > kMaxF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, nullptr, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return result(F == 1 ? launch<1, false>(p, semiring, idx16, steal,
                                          block_major, st)
                       : launch<kMaxF, false>(p, semiring, idx16, steal,
                                              block_major, st));
}
