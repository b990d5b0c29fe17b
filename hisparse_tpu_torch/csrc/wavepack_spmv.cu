// Wavepack SpMV, SpMM and masked SpMV for Hopper (sm_90a): semiring
// products over a packed tile stream, for one vector (SpMV), up to kMaxF
// feature columns (SpMM) in one pass, or one vector over a selected subset
// of the tiles (the masked SpMSpV analog).  Stream values are fp32, bf16
// (widened to fp32 on load) or saturating unsigned Q8.24.
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
// The algebra (kSr) is plus_times (acc + v*x, from 0), min_plus
// (min(acc, v + x), from +inf), max_times (max(acc, v*x), from -inf) or,
// for Q8.24 packs, fixed (the saturating multiply-add of
// ap_ufixed<32,8,AP_RND,AP_SAT>, from 0; acc, v and x are Q8.24 words).
// Each float operation is rounded once (__fmul_rn, __fadd_rn), as the
// plain PyTorch versions do; a bf16 value is widened exactly and x and the
// accumulator stay fp32, as in the TPU kernel (_tile_routed).  The fixed
// madd forms p = v*x + 2^23 in 64 bits (it cannot wrap: p < 2^64), takes
// p >> 24, saturated to 0xFFFFFFFF when p >= 2^56, and adds with
// saturation: bit for bit _fixed_madd.  min and max take the new term when it is smaller
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
// read once for all F features: 4 B of value (2 B in bf16) plus 2 B
// (idx16) or 4 B of idx word, 6 B/slot with idx16 or bf16 values.  At F = 1 XT and the tile metadata are
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
#include <type_traits>

#include <cuda_runtime.h>

#include "route.cuh"

namespace {

using namespace wavepack;

constexpr int kMaxF = 16;                // features in registers

// the algebra of kernel template argument kSr; the first three are the
// semiring values ops/_kernels.py passes, kFixed follows from vtype
constexpr int kPlusTimes = 0;
constexpr int kMinPlus = 1;
constexpr int kMaxTimes = 2;
constexpr int kFixed = 3;
// the stream value types of the vtype argument (ops/_kernels.py)
constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kQ824 = 2;

// the accumulator, x and product type of algebra kSr
template <int kSr>
using Acc = typename std::conditional<kSr == kFixed, uint32_t, float>::type;

struct Params {
  const void* vals;                      // (T, S, 128) fp32, bf16 or Q8.24
  const void* idxT;                      // (T, S, 128) int16 or int32
  const int32_t* tile_ids;               // (n_sel,), masked only
  const int32_t* tile_part;              // (T,)
  const int32_t* cmap;                   // (T, S/128, K), block-major only
  const int32_t* run_start;              // (n_blocks,)
  const int32_t* run_end;                // (n_blocks,)
  const void* xt;                        // (n_parts, F, CT, 128, 128) Acc
  void* out;                             // (F, n_blocks * S, 128) Acc
  int n_blocks, S, n_ops, K, CT, F;
};

template <int kSr>
__device__ __forceinline__ Acc<kSr> identity() {
  if constexpr (kSr == kFixed) {
    return 0u;
  } else {
    return kSr == kMinPlus ? __int_as_float(0x7f800000)      // +inf
           : kSr == kMaxTimes ? __int_as_float(0xff800000)   // -inf
                              : 0.0f;
  }
}

// a stored value as a 32-bit word: fp32 and Q8.24 words as they are, a
// bf16 value widened exactly to the fp32 bits it stands for
__device__ __forceinline__ uint32_t widen(uint32_t w) { return w; }
__device__ __forceinline__ uint32_t widen(uint16_t h) {
  return static_cast<uint32_t>(h) << 16;
}

// acc (+) v (x) x: floats rounded once an operation, min and max keeping a
// NaN; Q8.24 with round-half-up and saturation (see the header)
template <int kSr, typename T>
__device__ __forceinline__ T combine(T acc, T v, T x) {
  if constexpr (kSr == kFixed) {
    const uint64_t prod = static_cast<uint64_t>(v) * x + (1u << 23);
    const uint32_t t = (prod >> 56) ? 0xFFFFFFFFu
                                    : static_cast<uint32_t>(prod >> 24);
    const uint32_t s = acc + t;
    return s < acc ? 0xFFFFFFFFu : s;
  } else if constexpr (kSr == kMinPlus) {
    const float t = __fadd_rn(v, x);
    return (t < acc || isnan(t)) ? t : acc;
  } else if constexpr (kSr == kMaxTimes) {
    const float t = __fmul_rn(v, x);
    return (t > acc || isnan(t)) ? t : acc;
  } else {
    return __fadd_rn(acc, __fmul_rn(v, x));
  }
}

// kF accumulators a thread, of which the first p.F are live (p.F == 1
// when kF == 1, and the SpMV code is then free of the feature loop).
// ValT is the stored value word: uint32_t (fp32 or Q8.24) or uint16_t
// (bf16).
template <typename ValT, typename IdxT, bool kSteal, bool kBlockMajor,
          int kF, int kSr, bool kMasked>
__global__ void __launch_bounds__(kThreads)
wavepack_kernel(const Params p) {
  using A = Acc<kSr>;
  const ValT* __restrict__ vals = static_cast<const ValT*>(p.vals);
  const IdxT* __restrict__ idxT = static_cast<const IdxT*>(p.idxT);
  const int32_t* __restrict__ tile_part = p.tile_part;
  const A* __restrict__ xt = static_cast<const A*>(p.xt);
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
  A acc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = identity<kSr>();
  const int i_end = p.run_end[b];
  for (int i = p.run_start[b]; i < i_end; ++i) {
    const int t = kMasked ? p.tile_ids[i] : i;
    const int64_t tile = static_cast<int64_t>(t) * S * kLanes;
    stage_idx(sidx, idxT, tile, s0);
    __syncthreads();
    uint32_t vbits =
        widen(vals[tile + static_cast<int64_t>(s) * kLanes + l]);
    const int off = route<kSteal, kBlockMajor>(vbits, sidx, rr, l, t, s0,
                                               p.cmap, G, p.K, p.n_ops);
    A v;
    if constexpr (kSr == kFixed) {
      v = vbits;
    } else {
      v = __uint_as_float(vbits);
    }
    const A* __restrict__ xf =
        xt + static_cast<int64_t>(tile_part[t]) * F * page + off;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      if (f < F) acc[f] = combine<kSr>(acc[f], v, xf[f * page]);
    }
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(p.n_blocks) * S * kLanes;
  A* out = static_cast<A*>(p.out) + (static_cast<int64_t>(b) * S + s) *
                                        kLanes + l;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f < F) out[f * stride] = acc[f];
  }
}

// Launches the instantiation for the run-time semiring, value type and
// pack flags; returns false, launching nothing, for a combination the
// packer refuses (config.py): min_plus with steal_mantissa (or idx16, which
// needs it), idx16 without steal_mantissa, a bf16 or Q8.24 stream with
// steal_mantissa or another semiring than plus_times, an unknown semiring
// or value type; and for Q8.24 SpMM or masked SpMV, which the JAX package
// refuses too.
template <int kF, bool kMasked>
bool launch(const Params& p, int semiring, int vtype, bool idx16,
            bool steal, bool block_major, cudaStream_t st) {
  const dim3 grid(p.n_blocks * (p.S / kRows));
  if (vtype == kBf16 || vtype == kQ824) {
    if (semiring != kPlusTimes || steal || idx16 ||
        (vtype == kQ824 && (kF != 1 || kMasked))) {
      return false;
    }
    auto go = [&](auto bm) {
      constexpr bool kBm = decltype(bm)::value;
      if (vtype == kBf16) {
        wavepack_kernel<uint16_t, int32_t, false, kBm, kF, kPlusTimes,
                        kMasked><<<grid, kThreads, 0, st>>>(p);
      } else if constexpr (kF == 1 && !kMasked) {
        wavepack_kernel<uint32_t, int32_t, false, kBm, 1, kFixed, false>
            <<<grid, kThreads, 0, st>>>(p);
      }
    };
    if (block_major) {
      go(std::true_type{});
    } else {
      go(std::false_type{});
    }
    return true;
  }
  bool ok = vtype == kF32 &&
            (semiring == kPlusTimes || semiring == kMaxTimes ||
             (semiring == kMinPlus && !steal));
  ok = ok && dispatch(idx16, steal, block_major,
                      [&](auto idx, auto st_, auto bm) {
    using Idx = decltype(idx);
    constexpr bool kSt = decltype(st_)::value;
    constexpr bool kBm = decltype(bm)::value;
    if (semiring == kPlusTimes) {
      wavepack_kernel<uint32_t, Idx, kSt, kBm, kF, kPlusTimes, kMasked>
          <<<grid, kThreads, 0, st>>>(p);
    } else if (semiring == kMaxTimes) {
      wavepack_kernel<uint32_t, Idx, kSt, kBm, kF, kMaxTimes, kMasked>
          <<<grid, kThreads, 0, st>>>(p);
    } else if constexpr (!kSt) {
      wavepack_kernel<uint32_t, Idx, kSt, kBm, kF, kMinPlus, kMasked>
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
  return Params{vals, idxT,
                static_cast<const int32_t*>(tile_ids),
                static_cast<const int32_t*>(tile_part),
                static_cast<const int32_t*>(cmap),
                static_cast<const int32_t*>(run_start),
                static_cast<const int32_t*>(run_end),
                xt, out, n_blocks, S, n_ops, K, CT, F};
}

int result(bool ok) {
  return ok ? static_cast<int>(cudaGetLastError())
            : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points, loaded with ctypes (ops/_kernels.py).  Shapes: vals and
// idxT (T, S, 128); tile_part (T,); cmap (T, S/128, K) or null; run_start
// and run_end (n_blocks,).  semiring: 0 plus_times, 1 min_plus, 2
// max_times.  vtype: 0 fp32 values, 1 bf16 values (x and out fp32), 2
// Q8.24 values (x and out Q8.24 words too).  Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, launching
// nothing, for operands it refuses.
//
// SpMV: xt (n_parts, CT, 128, 128); out (n_blocks*S, 128).
extern "C" int wavepack_spmv_launch(const void* vals, const void* idxT,
                                    int idx16, int steal, int block_major,
                                    int semiring, int vtype,
                                    const void* tile_part, const void* cmap,
                                    const void* run_start,
                                    const void* run_end, const void* xt,
                                    void* out, int n_blocks, int S,
                                    int n_ops, int K, int CT, void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, nullptr, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1);
  return result(launch<1, false>(p, semiring, vtype, idx16, steal,
                                 block_major,
                                 static_cast<cudaStream_t>(stream)));
}

// Masked SpMV: tile_ids (n_sel,) the selected tiles in stream order;
// run_start / run_end each block's run into tile_ids; otherwise as SpMV
// (fp32 and bf16 streams).
extern "C" int wavepack_spmv_masked_launch(
    const void* vals, const void* idxT, int idx16, int steal,
    int block_major, int semiring, int vtype, const void* tile_ids,
    const void* tile_part, const void* cmap, const void* run_start,
    const void* run_end, const void* xt, void* out, int n_blocks, int S,
    int n_ops, int K, int CT, void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, tile_ids, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1);
  return result(launch<1, true>(p, semiring, vtype, idx16, steal,
                                block_major,
                                static_cast<cudaStream_t>(stream)));
}

// SpMM: xt (n_parts, F, CT, 128, 128); out (F, n_blocks*S, 128),
// 1 <= F <= 16 (fp32 and bf16 streams).
extern "C" int wavepack_spmm_launch(const void* vals, const void* idxT,
                                    int idx16, int steal, int block_major,
                                    int semiring, int vtype,
                                    const void* tile_part, const void* cmap,
                                    const void* run_start,
                                    const void* run_end, const void* xt,
                                    void* out, int n_blocks, int S,
                                    int n_ops, int K, int CT, int F,
                                    void* stream) {
  if (S % kLanes != 0 || n_blocks < 1 || n_ops < 1 || F < 1 || F > kMaxF ||
      vtype == kQ824) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, nullptr, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return result(F == 1 ? launch<1, false>(p, semiring, vtype, idx16, steal,
                                          block_major, st)
                       : launch<kMaxF, false>(p, semiring, vtype, idx16,
                                              steal, block_major, st));
}
