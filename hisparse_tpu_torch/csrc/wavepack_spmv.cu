// Wavepack SpMV, SpMM and masked SpMV for Hopper (sm_90a): semiring
// products over a packed tile stream, for one vector (SpMV), up to kWideF
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
// kernel body, instantiated at kF = 1 for SpMV, at kF = 4, 8, 16 or 64
// for SpMM and with kMasked for the masked call.
//
// What it computes.  For every feature f < F and accumulator slot
// (b, s, l) of row block b:
//
//   acc[f, b, s, l] = (+) over the tiles t of b's run, in run order, of
//                     vals'[t, s, l] (x) XT[part[t], blk, src, h, f]
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
// comes out at the identity.  SpMV reads build_xt's (n_parts, CT, 128,
// 128) XT; SpMM reads build_xt_multi's feature-innermost (n_parts, CT,
// 128, 128, Fp), Fp = F rounded up to a multiple of 4 with zero padding
// features (ops/spmv.py).
//
// Mapping.  One thread per accumulator slot: a CTA owns kR consecutive
// sublanes of one row block (kR * 128 threads, lane l fastest) and walks
// that block's run: kR = 8 for SpMV and the masked SpMV when the pack
// gives more than 1.5 such CTAs an SM, else 4 (pick()), and kWideFRows
// for SpMM at kF = 64, 4 at its narrower widths.  No
// atomics, the same result every run, and each slot folds its terms in
// the TPU's sequential grid order.  The thread routes its slot once per
// tile and keeps kF accumulators in registers, so each feature folds its
// terms in stream order and the result does not depend on how the caller
// chunks the features.  The masked call reads only the selected tiles: a
// skipped tile costs no device-memory traffic.
//
// The tile pipeline.  A ring of kAhead + 1 tiles in shared memory
// (kAhead = kStepsAhead, or kWideFAhead at kF = 64); each stage holds what
// the CTA reads of one tile: its kR sublanes' values, the 128 x kR
// transposed idx words its crossbar lookups read, the group's class_map
// row, the partition id and, for the masked call, the tile id kAhead
// further on.  The first warps copy the values and the next the idx rows
// in cp.async chunks of up to 16 bytes (kR * 2 or kR * 4 bytes a row),
// one more the small words; the tile ids of the masked run travel ahead
// in the ring, so no thread waits on a global load to address a copy.
// Tiles i+1 .. i+kAhead are in flight while tile i is folded,
// and one barrier a tile both publishes tile i and frees the stage the
// next copy reuses.  A tile's critical path is shared-memory reads, one
// gather of x and the fold: no device-memory round trip.
//
// What bounds it.  SpMV and the masked SpMV (kF = 1, every algebra and
// value type) read every slot of the stream (or of the selected tiles)
// once: 4 B of value (2 B in bf16) plus 2 B (idx16) or 4 B of idx word;
// XT, the metadata and the output are small beside it, so HBM bandwidth
// bounds them.  Two things stand between them and that bound.  (1) The
// x gathers: one 4-byte load a slot at a routed address, 32 sectors a warp
// where the crossbar scatters, which the SM's L1 serves at about one
// sector a clock and misses to L2 when shared memory has taken its room;
// on a pack whose slots are mostly real (googleplus) they, not the stream,
// set the time.  So the ring is kept small (2 tiles ahead: 12-25 KB a
// CTA, 2 CTAs an SM) and the copies bypass L1.  (2) The stream's latency:
// a pack with few row blocks gives one wave of CTAs (googleplus: 4
// blocks, 256 CTAs of 8 sublanes on 132 SMs), so the bytes in flight come
// from depth: 2 tiles of 6-8 KB a CTA.  A CTA of 8 sublanes reads each
// idx row as whole 32-byte sectors (int32; idx16 16 bytes), so no two
// CTAs split a sector; a deeper ring, or 4-sublane CTAs, measured slower
// on the long, nearly empty runs of the SSSP combine levels, where the
// stream alone sets the time.  A pack of few row blocks takes 4-sublane
// CTAs when its 8-sublane grid is at most 1.5 CTAs an SM: a pack of one
// row block (512 sublanes) would give only 64 such CTAs for 132 SMs, and
// one of three (the 4-partition PageRank pack) 192, two on some SMs (16
// sublanes) where 4-sublane CTAs put at most three (12).  Above that the
// narrow grid's busiest SM holds as many sublanes as the wide one's
// (googleplus: 16 either way), and the wide one reads whole sectors.
// __launch_bounds__ keeps the SM's 2,048 threads resident
// at kF = 1 in either shape (32 registers a thread, the whole register
// file).  The ring is static shared memory under the 48 KB that
// needs no opt-in, so launch() sets no dynamic-memory attribute.  SpMM
// (kF = 4, 8, 16): each slot gathers its Fp features as Fp/4 16-byte
// loads of one contiguous row of XT (1 or 2 32-byte sectors, where one
// feature a load cost a sector each), so the gathers' sectors, 64 B a
// slot at F = 16 against 6 B of stream, set its time; XT is Fp * CT * 64
// KB a partition and stays in L2.  __launch_bounds__(512, 2) gives its 16
// accumulators room (52-61 registers, 2 CTAs of 4 sublanes an SM).  Above
// 16 features one wide instantiation (kF = kWideF = 64) reads each tile
// once for up to 64: on a pack that is mostly padding, 16 features a
// launch read the stream once per 16 at about 1.2 TB/s (the products GCN
// pack, 13.2 GB at fill 7.65%: 10.7 ms a kF = 16 launch), and more bytes
// in flight were meant to lift that.  On an H100 the wide launch takes
// 37.75 ms at F = 64 against 42.93 for four kF = 16 launches, bit-equal,
// and 2 to 10 tiles ahead time the same (37.6-38.0 ms; 4 KB a tile, 1 CTA
// an SM): past 16 features the real slots' gathers, 256 B of XT a slot at
// F = 64 behind each tile's barrier, set the time (about 0.47 ms a
// feature), not the stream (3.9 ms at 3.35 TB/s).  Its 64 accumulators
// take 112-114 registers, so __launch_bounds__ keeps kWideFThreads (512)
// an SM; the ring stays 8 tiles ahead (37 KB, static).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "route.cuh"

namespace {

using namespace wavepack;

constexpr int kMaxF = 16;                // the widest narrow SpMM
// A CTA owns kR sublanes (kR * 128 threads): kWideRows at kF = 1, whose
// rows of idx words are then whole 32-byte sectors (int32) or 16-byte
// copies (idx16), unless that leaves at most 1.5 CTAs an SM (a pack of one
// row block: 64; of three: 192); kNarrowRows then, and for SpMM up to kMaxF
// features, whose accumulators need the registers.  The ring holds
// kStepsAhead + 1 tiles.
constexpr int kWideRows = 8;
constexpr int kNarrowRows = 4;
constexpr int kStepsAhead = 2;
// The wide SpMM: kWideF features a launch in CTAs of kWideFRows sublanes
// with kWideFAhead tiles in flight, kWideFThreads threads an SM (128
// registers a thread for the accumulators).
constexpr int kWideF = 64;
constexpr int kWideFRows = 4;
constexpr int kWideFAhead = 8;
constexpr int kWideFThreads = 512;
constexpr int kMaxK = 8;                 // classes_per_group (config.py)

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
  const void* xt;                        // (n_parts, CT, 128, 128, Fp) Acc
  void* out;                             // (F, n_blocks * S, 128) Acc
  int n_blocks, S, n_ops, K, CT, F, Fp;  // F <= Fp; Fp == 1 for SpMV
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

// One stage of the ring: what a CTA of kR sublanes reads of one tile t.
template <typename ValT, typename IdxT, int kR>
struct __align__(16) Stage {
  ValT vals[kR * kLanes];                // vals[t, s0 + q, l] at q*128 + l
  IdxT idx[kLanes][kR];                  // idx[j][q]: gather slot (s0+q, j)
  int32_t cmap[kMaxK];                   // class_map[t, s0 / 128, :]
  int32_t part;                          // tile_part[t]
  int32_t next;                          // masked: the tile kAhead further
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an asynchronous copy of kBytes (4, 8 or 16) from device to shared
// memory; 16-byte copies bypass L1, and a miss fetches the whole 128-byte
// line into L2, where the CTAs that read the rest of an idx row find it
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issues the copies of tile t into stage st, one chunk a thread: the
// values (threads from 0), the idx words' rows (from kIdx0, in chunks of
// up to 16 bytes), the class-map row, the partition id and, for the masked
// call, tile_ids[next] (when has_next) into st.next.
template <typename ValT, typename IdxT, int kR, bool kBlockMajor,
          bool kMasked>
__device__ __forceinline__ void issue(Stage<ValT, IdxT, kR>& st,
                                      const Params& p, int t, int next,
                                      bool has_next, int s0) {
  constexpr int kIdx0 = kR * kLanes * sizeof(ValT) / 16;
  constexpr int kRowBytes = kR * sizeof(IdxT);
  constexpr int kChunk = kRowBytes < 16 ? kRowBytes : 16;
  constexpr int kPerRow = kRowBytes / kChunk;
  constexpr int kMeta0 = kIdx0 + kLanes * kPerRow;
  static_assert(kMeta0 + kMaxK + 2 <= kR * kLanes, "a thread a copy");
  const int tid = threadIdx.x;
  if (tid >= kMeta0 + kMaxK + 2) return;
  const int64_t tile = static_cast<int64_t>(t) * p.S * kLanes;
  if (tid < kIdx0) {
    cp_async<16>(reinterpret_cast<char*>(st.vals) + tid * 16,
                 static_cast<const char*>(p.vals) +
                     (tile + static_cast<int64_t>(s0) * kLanes) *
                         static_cast<int64_t>(sizeof(ValT)) +
                     tid * 16);
  } else if (tid < kMeta0) {
    const int j = (tid - kIdx0) / kPerRow;
    const int c = (tid - kIdx0) % kPerRow;
    cp_async<kChunk>(
        reinterpret_cast<char*>(&st.idx[j][0]) + c * kChunk,
        reinterpret_cast<const char*>(
            static_cast<const IdxT*>(p.idxT) + tile +
            static_cast<int64_t>((s0 / kLanes) * kLanes + j) * kLanes +
            s0 % kLanes) + c * kChunk);
  } else {
    const int k = tid - kMeta0;
    if (kBlockMajor && k < p.K) {
      cp_async<4>(&st.cmap[k],
                  p.cmap + (static_cast<int64_t>(t) * (p.S / kLanes) +
                            s0 / kLanes) * p.K + k);
    } else if (k == kMaxK) {
      cp_async<4>(&st.part, p.tile_part + t);
    } else if (kMasked && k == kMaxK + 1 && has_next) {
      cp_async<4>(&st.next, p.tile_ids + next);
    }
  }
}

// kF accumulators a thread, of which the first p.F are written (p.F == 1
// when kF == 1, and the SpMV code is then free of the feature loop), and
// kAhead tiles in flight.  ValT is the stored value word: uint32_t (fp32
// or Q8.24) or uint16_t (bf16).
template <typename ValT, typename IdxT, bool kSteal, bool kBlockMajor,
          int kF, int kSr, bool kMasked, int kR, int kAhead = kStepsAhead>
__global__ void __launch_bounds__(
    kR * kLanes, kF == 1       ? 2048 / (kR * kLanes)
                 : kF <= kMaxF ? 2
                               : kWideFThreads / (kR * kLanes))
wavepack_kernel(const Params p) {
  using A = Acc<kSr>;
  constexpr int kRing = kAhead + 1;
  using St = Stage<ValT, IdxT, kR>;
  __shared__ St ring[kRing];
  const A* __restrict__ xt = static_cast<const A*>(p.xt);
  const int S = p.S;
  const int chunks = S / kR;
  const int b = blockIdx.x / chunks;
  const int s0 = (blockIdx.x % chunks) * kR;
  const int rr = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;

  A acc[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = identity<kSr>();
  // the run: positions 0 .. n-1, tile start + i (or tile_ids[start + i]);
  // the stage of position i carries the tile id of position i + kAhead
  const int start = p.run_start[b];
  const int n = p.run_end[b] - start;
  int first[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    first[k] = !kMasked ? start + k : k < n ? p.tile_ids[start + k] : 0;
  }
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k < n) {
      issue<ValT, IdxT, kR, kBlockMajor, kMasked>(
          ring[k], p, first[k], start + k + kAhead, k + kAhead < n, s0);
    }
    cp_async_commit();
  }
  // tile i's stage is cur; tile i + kAhead's is the one before it, tile
  // i - 1's, as kRing == kAhead + 1
  for (int i = 0, cur = 0; i < n;
       ++i, cur = cur + 1 == kRing ? 0 : cur + 1) {
    // tile i has landed (this thread's copies, then everyone's), and every
    // thread is done with tile i - 1, whose stage the next copy reuses
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    const St& st = ring[cur];
    const int j = i + kAhead;
    if (j < n) {
      issue<ValT, IdxT, kR, kBlockMajor, kMasked>(
          ring[cur == 0 ? kRing - 1 : cur - 1], p,
          kMasked ? st.next : start + j, start + j + kAhead,
          j + kAhead < n, s0);
    }
    cp_async_commit();
    uint32_t vbits = widen(st.vals[threadIdx.x]);    // sublane rr, lane l
    const int off = route<kSteal, kBlockMajor>(vbits, st.idx, rr, l,
                                               st.cmap, p.n_ops);
    A v;
    if constexpr (kSr == kFixed) {
      v = vbits;
    } else {
      v = __uint_as_float(vbits);
    }
    const int64_t slot = static_cast<int64_t>(st.part) * p.CT * kPage + off;
    if constexpr (kF == 1) {
      acc[0] = combine<kSr>(acc[0], v, __ldg(xt + slot));
    } else {
      // the slot's Fp features: Fp / 4 16-byte loads of one XT row
      const float4* __restrict__ xf =
          reinterpret_cast<const float4*>(xt) + slot * (p.Fp / 4);
#pragma unroll
      for (int g = 0; g < kF / 4; ++g) {
        if (4 * g < p.Fp) {
          const float4 x = __ldg(xf + g);
          acc[4 * g] = combine<kSr>(acc[4 * g], v, x.x);
          acc[4 * g + 1] = combine<kSr>(acc[4 * g + 1], v, x.y);
          acc[4 * g + 2] = combine<kSr>(acc[4 * g + 2], v, x.z);
          acc[4 * g + 3] = combine<kSr>(acc[4 * g + 3], v, x.w);
        }
      }
    }
  }
  const int F = kF == 1 ? 1 : p.F;
  const int64_t stride = static_cast<int64_t>(p.n_blocks) * S * kLanes;
  A* out = static_cast<A*>(p.out) +
           (static_cast<int64_t>(b) * S + s0 + rr) * kLanes + l;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f < F) out[f * stride] = acc[f];
  }
}

using Kernel = void (*)(Params);

// an instantiation, the sublanes a CTA of it owns and its tiles in flight
struct Choice {
  Kernel k;
  int rows;
  int ahead = kStepsAhead;
};

template <typename ValT, typename IdxT, bool kSt, bool kBm, int kF, int kSr,
          bool kMasked, int kR, int kAhead = kStepsAhead>
Kernel fn() {
  return wavepack_kernel<ValT, IdxT, kSt, kBm, kF, kSr, kMasked, kR, kAhead>;
}

// The instantiation for the run-time semiring, value type and pack flags,
// or nullptr for a combination the packer refuses (config.py): min_plus
// with steal_mantissa (or idx16, which needs it), idx16 without
// steal_mantissa, a bf16 or Q8.24 stream with steal_mantissa or another
// semiring than plus_times, an unknown semiring or value type; and for
// Q8.24 SpMM or masked SpMV, which the JAX package refuses too.
template <int kF, bool kMasked, int kR, int kAhead = kStepsAhead>
Kernel select(int semiring, int vtype, bool idx16, bool steal,
              bool block_major) {
  if (vtype == kBf16 || vtype == kQ824) {
    if (semiring != kPlusTimes || steal || idx16) return nullptr;
    if (vtype == kBf16) {
      return block_major
                 ? fn<uint16_t, int32_t, false, true, kF, kPlusTimes,
                      kMasked, kR, kAhead>()
                 : fn<uint16_t, int32_t, false, false, kF, kPlusTimes,
                      kMasked, kR, kAhead>();
    }
    if constexpr (kF == 1 && !kMasked) {
      return block_major ? fn<uint32_t, int32_t, false, true, 1, kFixed,
                              false, kR>()
                         : fn<uint32_t, int32_t, false, false, 1, kFixed,
                              false, kR>();
    }
    return nullptr;
  }
  Kernel k = nullptr;
  if (vtype != kF32) return k;
  dispatch(idx16, steal, block_major, [&](auto idx, auto st_, auto bm) {
    using Idx = decltype(idx);
    constexpr bool kSt = decltype(st_)::value;
    constexpr bool kBm = decltype(bm)::value;
    if (semiring == kPlusTimes) {
      k = fn<uint32_t, Idx, kSt, kBm, kF, kPlusTimes, kMasked, kR, kAhead>();
    } else if (semiring == kMaxTimes) {
      k = fn<uint32_t, Idx, kSt, kBm, kF, kMaxTimes, kMasked, kR, kAhead>();
    } else if constexpr (!kSt) {
      if (semiring == kMinPlus) {
        k = fn<uint32_t, Idx, kSt, kBm, kF, kMinPlus, kMasked, kR, kAhead>();
      }
    }
  });
  return k;
}

// the kernels of the C entry points
constexpr int kSpmv = 0;
constexpr int kMaskedSpmv = 1;
constexpr int kSpmm = 2;

// The SMs of the current device, read once.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, m = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess) {
      n = m;
    }
  }
  return n;
}

// The instantiation of entry point `which` (kSpmv, kMaskedSpmv or kSpmm,
// the latter at kF = 4, 8 or 16 for Fp features up to kMaxF, at kWideF
// above) for a grid of n_blocks row blocks of S sublanes, or a null
// kernel.
Choice pick(int which, int semiring, int vtype, bool idx16, bool steal,
            bool block_major, int Fp, int n_blocks, int S) {
  if (which == kSpmv || which == kMaskedSpmv) {
    const bool wide = 2 * n_blocks * (S / kWideRows) > 3 * sm_count();
    const bool m = which == kMaskedSpmv;
    if (wide) {
      return {m ? select<1, true, kWideRows>(semiring, vtype, idx16, steal,
                                             block_major)
                : select<1, false, kWideRows>(semiring, vtype, idx16, steal,
                                              block_major),
              kWideRows};
    }
    return {m ? select<1, true, kNarrowRows>(semiring, vtype, idx16, steal,
                                             block_major)
              : select<1, false, kNarrowRows>(semiring, vtype, idx16, steal,
                                              block_major),
            kNarrowRows};
  }
  if (which != kSpmm || vtype == kQ824 || Fp < 1 || Fp > kWideF) {
    return {nullptr, 0};
  }
  if (Fp > kMaxF) {
    return {select<kWideF, false, kWideFRows, kWideFAhead>(
                semiring, vtype, idx16, steal, block_major),
            kWideFRows, kWideFAhead};
  }
  const Kernel k =
      Fp <= 4 ? select<4, false, kNarrowRows>(semiring, vtype, idx16, steal,
                                              block_major)
      : Fp <= 8
          ? select<8, false, kNarrowRows>(semiring, vtype, idx16, steal,
                                          block_major)
          : select<kMaxF, false, kNarrowRows>(semiring, vtype, idx16, steal,
                                              block_major);
  return {k, kNarrowRows};
}

// Launches c's kernel on p's grid, c.rows sublanes a CTA; returns
// cudaGetLastError() after the launch (a launch refused for its registers
// or shared memory included), or cudaErrorInvalidValue, launching nothing,
// for a null kernel.
int launch(Choice c, const Params& p, cudaStream_t st) {
  if (c.k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  c.k<<<dim3(p.n_blocks * (p.S / c.rows)), c.rows * kLanes, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* vals, const void* idxT, const void* tile_ids,
                   const void* tile_part, const void* cmap,
                   const void* run_start, const void* run_end,
                   const void* xt, void* out, int n_blocks, int S, int n_ops,
                   int K, int CT, int F, int Fp) {
  return Params{vals, idxT,
                static_cast<const int32_t*>(tile_ids),
                static_cast<const int32_t*>(tile_part),
                static_cast<const int32_t*>(cmap),
                static_cast<const int32_t*>(run_start),
                static_cast<const int32_t*>(run_end),
                xt, out, n_blocks, S, n_ops, K, CT, F, Fp};
}

bool bad_shape(int n_blocks, int S, int n_ops, int K, bool block_major) {
  return S % kLanes != 0 || n_blocks < 1 || n_ops < 1 ||
         (block_major && (K < 1 || K > kMaxK));
}

}  // namespace

// C entry points, loaded with ctypes (ops/_kernels.py).  Shapes: vals and
// idxT (T, S, 128), 16-byte aligned; tile_part (T,); cmap (T, S/128, K) or
// null; run_start and run_end (n_blocks,).  semiring: 0 plus_times, 1
// min_plus, 2 max_times.  vtype: 0 fp32 values, 1 bf16 values (x and out
// fp32), 2 Q8.24 values (x and out Q8.24 words too).  Each returns
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
  if (bad_shape(n_blocks, S, n_ops, K, block_major)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, nullptr, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1, 1);
  return launch(pick(kSpmv, semiring, vtype, idx16, steal, block_major, 1,
                     n_blocks, S),
                p, static_cast<cudaStream_t>(stream));
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
  if (bad_shape(n_blocks, S, n_ops, K, block_major)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, tile_ids, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, 1, 1);
  return launch(pick(kMaskedSpmv, semiring, vtype, idx16, steal,
                     block_major, 1, n_blocks, S),
                p, static_cast<cudaStream_t>(stream));
}

// SpMM: xt (n_parts, CT, 128, 128, Fp), 16-byte aligned, Fp a multiple of
// 4 up to kWideF; out (F, n_blocks*S, 128), 1 <= F <= Fp (fp32 and bf16
// streams).
extern "C" int wavepack_spmm_launch(const void* vals, const void* idxT,
                                    int idx16, int steal, int block_major,
                                    int semiring, int vtype,
                                    const void* tile_part, const void* cmap,
                                    const void* run_start,
                                    const void* run_end, const void* xt,
                                    void* out, int n_blocks, int S,
                                    int n_ops, int K, int CT, int F, int Fp,
                                    void* stream) {
  if (bad_shape(n_blocks, S, n_ops, K, block_major) || Fp % 4 != 0 ||
      F < 1 || F > Fp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(vals, idxT, nullptr, tile_part, cmap,
                               run_start, run_end, xt, out, n_blocks, S,
                               n_ops, K, CT, F, Fp);
  return launch(pick(kSpmm, semiring, vtype, idx16, steal, block_major, Fp,
                     n_blocks, S),
                p, static_cast<cudaStream_t>(stream));
}

// What the instantiation an entry point launches for these flags and a
// grid of n_blocks row blocks of S sublanes uses: which 0 SpMV, 1 masked
// SpMV, 2 SpMM at Fp features.  Writes to info[0..6]
// its registers a thread, static and dynamic shared memory bytes a CTA,
// local (spilled) bytes a thread, resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the ring's tiles and
// the threads a CTA.  Returns a CUDA error code, cudaErrorInvalidValue for
// flags no instantiation takes.
extern "C" int wavepack_kernel_info(int which, int semiring, int vtype,
                                    int idx16, int steal, int block_major,
                                    int Fp, int n_blocks, int S, int* info) {
  const Choice c = pick(which, semiring, vtype, idx16, steal, block_major,
                        Fp, n_blocks, S);
  if (c.k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, c.k);
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, c.k,
                                                      c.rows * kLanes, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes);
  info[2] = 0;
  info[3] = static_cast<int>(a.localSizeBytes);
  info[4] = ctas;
  info[5] = c.ahead + 1;
  info[6] = c.rows * kLanes;
  return 0;
}
