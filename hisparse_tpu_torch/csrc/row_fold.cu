// The renamed -> natural row fold for Hopper (sm_90a): each natural row of
// a wavepack result gathers its hub-split partials from the renamed
// (packed) rows and folds them in one fixed order.
//
// Replaces the host recombine Wavepack.unpack_y (hisparse_tpu/formats/
// wavepack.py, np.add.at / np.minimum.at / np.maximum.at over perm), which
// the JAX operator's forward and masked call end in; the TPU had no
// kernel for it.  An index_add_ or scatter_reduce_ over perm adds a row's
// partials in no fixed order on the card; this fold gives the same bits
// every run, those of unpack_y.
//
// What it computes.  For every feature f < F and natural row r:
//
//   out[r, f] = fold over j = ptr[r] .. ptr[r+1] - 1, in ascending j, of
//               y[idx[j], f], from the algebra's identity
//
// with (idx, ptr) the valid renamed positions stably sorted by natural row
// (ops/spmv.py:fold_plan), so a row's partials come in ascending renamed
// order, as np.add.at visits them.  The algebra: plus_times (acc + t,
// rounded once, from 0), min_plus and max_times (numpy's minimum and
// maximum: a NaN on either side wins, a tie takes the new partial, from
// +inf / -inf; max_times then clamps at 0 as np.maximum(out, 0) does, so
// empty rows come out at 0), or Q8.24 (uint32 words summed in 64 bits and
// clamped at 0xFFFFFFFF, unpack_y's closed form of repeated saturating
// adds of nonnegative words).  No atomics.
//
// Layouts.  y is (n_ren, F) with the features innermost (what
// SpmvOperator.matmul folds) and out (n_rows, F), or y is (F, n_ren) and
// out (F, n_rows) (a vector, the mesh, renamed matmul output): one kernel,
// given the strides of a row and of a feature.
//
// Mapping.  A row of up to thread_max partials (FOLD_THREAD_MAX in
// ops/spmv.py, 32; almost every row) folds on one thread.  Features
// innermost, a thread takes a row and up to kChunk (16) of its features:
// it reads each partial's idx word once and the features as 16-byte loads
// where F % 4 == 0 (y and out 16-byte aligned), else as scalars.  Features
// outermost (or F = 1), a thread takes one (f, row), as neighbouring rows
// of one feature lie side by side.  A hub row (more partials, listed in
// long_rows, longest first) folds on one warp, kHubW (4) of its features
// a warp (one feature, features outermost): the warp keeps a ring of
// kStages stages in shared memory filled by cp.async gathers (16-byte ones
// of a partial's 4 features where the thread path takes 16-byte loads),
// three stages ahead of the fold, the idx words of the next stages in
// registers two stages ahead of their gathers, and every lane walks the
// same fold, so no lane waits at a barrier for another.  How it folds:
//
//  - plus_times keeps the ascending serial chain (a sum's bits depend on
//    its order), each add waiting only on the one before.  One feature
//    reads a stage as 16-byte words, four partials each, kAhead words
//    ahead of the adds, and a whole stage is unrolled with the gathers and
//    idx loads of later stages between its adds; with W features, lane f
//    adds feature f of each partial;
//  - min_plus and max_times, whose step (Fold::add) keeps the first NaN
//    and otherwise the last partial equal to the extreme, are associative:
//    each of a stage's 32 / Wp slots (Wp: W rounded up to a power of two)
//    folds a contiguous segment of its partials in order, and the slots'
//    folds combine as a tree whose left operand always holds the earlier
//    segment, so the bits are the chain's in about L / 32 + 5 steps a
//    stage for a row of L partials;
//  - Q8.24 sums in 64 bits in any order: each lane sums its segments and
//    the warp's tree adds them once at the end before the one clamp.
//
// The hub CTAs (kHubWarps hub items each, the longest rows in the first)
// come first in the grid, so the longest chains start at once, few to an
// SM, and the short rows fill the SMs under them.
//
// What bounds it.  y is read once, idx once, out written once: bytes over
// HBM bandwidth, a few microseconds.  The longest plus_times hub row is the
// other floor: its partials add one after another, one dependent add each
// (fadd_latency_launch measures that add's latency in clocks).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHubWarps = 2;             // hub items a CTA (its other warps
                                         // exit)
constexpr int kChunk = 16;               // features a thread folds
constexpr int kHubW = 4;                 // features a hub warp folds
constexpr int kStages = 4;               // stages of a hub warp's ring
constexpr int kStageWords = 256;         // 4-byte words a stage
constexpr int kRingWords = kStages * kStageWords;
constexpr int kAhead = 4;                // 16-byte words read ahead of the
                                         // plus_times chain (one feature)

constexpr int kPlusTimes = 0;            // the alg argument (ops/_kernels.py)
constexpr int kMinPlus = 1;
constexpr int kMaxTimes = 2;
constexpr int kFixed = 3;

constexpr int kOne = 0;                  // one feature a thread / hub warp
constexpr int kInner = 1;                // features innermost, scalar loads
constexpr int kInnerV4 = 2;              // features innermost, 16-byte loads

// In: the stored partial; Acc: the running fold
template <int kAlg>
struct Fold {
  using In = float;
  using Acc = float;
  __device__ static Acc init() {
    return kAlg == kMinPlus ? __int_as_float(0x7f800000)       // +inf
           : kAlg == kMaxTimes ? __int_as_float(0xff800000)    // -inf
                               : 0.0f;
  }
  __device__ static Acc add(Acc a, In t) {
    if (kAlg == kMinPlus) return (a < t || isnan(a)) ? a : t;
    if (kAlg == kMaxTimes) return (a > t || isnan(a)) ? a : t;
    return __fadd_rn(a, t);
  }
  __device__ static In done(Acc a) {
    if (kAlg == kMaxTimes) return (a > 0.0f || isnan(a)) ? a : 0.0f;
    return a;
  }
  __device__ static In word(uint32_t w) { return __uint_as_float(w); }
  __device__ static uint32_t bits(In v) { return __float_as_uint(v); }
};

template <>
struct Fold<kFixed> {
  using In = uint32_t;
  using Acc = uint64_t;
  __device__ static Acc init() { return 0ull; }
  __device__ static Acc add(Acc a, In t) { return a + t; }
  __device__ static In done(Acc a) {
    return a > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<uint32_t>(a);
  }
  __device__ static In word(uint32_t w) { return w; }
  __device__ static uint32_t bits(In v) { return v; }
};

struct Params {
  const void* y;
  const int32_t* idx;                    // (ptr[n_rows],)
  const int32_t* ptr;                    // (n_rows + 1,)
  const int32_t* long_rows;              // (n_long,)
  void* out;
  int n_rows, n_long, F, thread_max;
  int64_t y_sr, y_sf;                    // y's strides: renamed row, feature
  int64_t o_sr, o_sf;                    // out's: natural row, feature
  int n_fch;                             // a row's thread items
  int n_hch;                             // a hub row's warp items
  int64_t hub_blocks;                    // CTAs of the hub warps
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an asynchronous copy of kBytes (4 or 16) from device memory to the
// shared-memory address dst
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
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

template <int kAlg, typename Acc, typename In>
__device__ __forceinline__ Acc add4(Acc a, uint4 q) {
  using Fd = Fold<kAlg>;
  return Fd::add(Fd::add(Fd::add(Fd::add(a, Fd::word(q.x)), Fd::word(q.y)),
                         Fd::word(q.z)), Fd::word(q.w));
}

// chain = chain + word, rounded once, as an asm statement: the chain's
// adds keep their order and their loads go ahead of them (plus_times)
template <int kAlg, typename Acc>
__device__ __forceinline__ Acc chain_add(Acc a, uint32_t w) {
  if constexpr (kAlg == kPlusTimes) {
    asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(a) : "f"(__uint_as_float(w)));
    return a;
  } else {
    return Fold<kAlg>::add(a, Fold<kAlg>::word(w));
  }
}

// A row of up to thread_max partials on one thread: item i is (f, row)
// for kOne, (row, chunk of kChunk features) otherwise.
template <int kAlg, int kMode>
__device__ __forceinline__ void fold_rows(const Params& p, int64_t i) {
  using Fd = Fold<kAlg>;
  using In = typename Fd::In;
  using Acc = typename Fd::Acc;
  const In* __restrict__ y = static_cast<const In*>(p.y);
  In* __restrict__ out = static_cast<In*>(p.out);
  if (i >= static_cast<int64_t>(p.n_rows) * p.n_fch) return;
  int r, f0;
  if constexpr (kMode == kOne) {
    f0 = static_cast<int>(i / p.n_rows);
    r = static_cast<int>(i % p.n_rows);
  } else {
    r = static_cast<int>(i / p.n_fch);
    f0 = static_cast<int>(i % p.n_fch) * kChunk;
  }
  const int beg = __ldg(p.ptr + r);
  const int end = __ldg(p.ptr + r + 1);
  if (end - beg > p.thread_max) return;  // a hub warp writes it
  const In* yf = y + f0 * p.y_sf;
  In* o = out + r * p.o_sr + f0 * p.o_sf;
  if constexpr (kMode == kOne) {
    Acc a = Fd::init();
#pragma unroll 4
    for (int j = beg; j < end; ++j) {
      a = Fd::add(a, __ldg(yf + __ldg(p.idx + j)));   // y_sr is 1
    }
    *o = Fd::done(a);
  } else {
    const int nf = min(kChunk, p.F - f0);
    Acc a[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) a[q] = Fd::init();
#pragma unroll 2
    for (int j = beg; j < end; ++j) {
      const In* src = yf + __ldg(p.idx + j) * p.y_sr;
      if constexpr (kMode == kInnerV4) {
#pragma unroll
        for (int q = 0; q < kChunk; q += 4) {
          if (q < nf) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + q));
            a[q] = Fd::add(a[q], Fd::word(v.x));
            a[q + 1] = Fd::add(a[q + 1], Fd::word(v.y));
            a[q + 2] = Fd::add(a[q + 2], Fd::word(v.z));
            a[q + 3] = Fd::add(a[q + 3], Fd::word(v.w));
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          if (q < nf) a[q] = Fd::add(a[q], __ldg(src + q));
        }
      }
    }
    if constexpr (kMode == kInnerV4) {
#pragma unroll
      for (int q = 0; q < kChunk; q += 4) {
        if (q < nf) {
          *reinterpret_cast<uint4*>(o + q) = make_uint4(
              Fd::bits(Fd::done(a[q])), Fd::bits(Fd::done(a[q + 1])),
              Fd::bits(Fd::done(a[q + 2])), Fd::bits(Fd::done(a[q + 3])));
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (q < nf) o[q] = Fd::done(a[q]);
      }
    }
  }
}

// the idx words of the partials a lane copies for the stage from partial
// c on (-1: none)
template <int kCopies>
__device__ __forceinline__ void stage_idx(int (&ix)[kCopies],
                                          const int32_t* __restrict__ idx,
                                          const int (&pu)[kCopies], int c,
                                          int end) {
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int j = c + pu[k];
    ix[k] = pu[k] >= 0 && j < end ? __ldg(idx + j) : -1;
  }
}

// the lane's copies of one stage into the shared-memory address dst, and
// their commit (a group, empty or not, every stage keeps the count of
// groups fixed)
template <int kVec, int kCopies, typename In>
__device__ __forceinline__ void stage_copy(uint32_t dst, const In* yf,
                                           int64_t y_sr,
                                           const int (&ix)[kCopies],
                                           const int (&qu)[kCopies],
                                           int lane) {
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    if (ix[k] >= 0) {
      cp_async<4 * kVec>(dst + (lane + 32 * k) * kVec * 4,
                         yf + ix[k] * y_sr + qu[k]);
    }
  }
  cp_async_commit();
}

// One hub row, W of its features from f0, on one warp (item w).
template <int kAlg, int kMode>
__device__ __forceinline__ void fold_hub(const Params& p, int64_t w,
                                         typename Fold<kAlg>::In* ring) {
  using Fd = Fold<kAlg>;
  using In = typename Fd::In;
  using Acc = typename Fd::Acc;
  constexpr int kVec = kMode == kInnerV4 ? 4 : 1;
  constexpr int kCopies = kStageWords / (32 * kVec);   // a lane, a stage
  if (w >= static_cast<int64_t>(p.n_long) * p.n_hch) return;
  const int lane = threadIdx.x % 32;
  int r, f0, W;
  if constexpr (kMode == kOne) {
    f0 = static_cast<int>(w / p.n_long);
    r = __ldg(p.long_rows + w % p.n_long);
    W = 1;
  } else {
    r = __ldg(p.long_rows + w / p.n_hch);
    f0 = static_cast<int>(w % p.n_hch) * kHubW;
    W = min(kHubW, p.F - f0);
  }
  const int beg = __ldg(p.ptr + r);
  const int end = __ldg(p.ptr + r + 1);
  const In* yf = static_cast<const In*>(p.y) + f0 * p.y_sf;
  // features outermost, a renamed row's stride is 1
  const int64_t y_sr = kMode == kOne ? 1 : p.y_sr;
  const uint32_t ring_s = smem_addr(ring);
  // a stage holds kP whole partials of W words at stride W; the lane's
  // copy k moves unit lane + 32k (kVec words) of partial pu, word qu
  const int kP = kStageWords / W;
  const int Wv = W / kVec;
  int pu[kCopies], qu[kCopies];
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int u = lane + 32 * k;
    pu[k] = u / Wv < kP ? u / Wv : -1;
    qu[k] = (u % Wv) * kVec;
  }
  // prologue: stages 0 .. kStages-2 in flight, the idx words of the next
  // two in registers
  {
    int ix0[kCopies], ix1[kCopies], ix2[kCopies];
    stage_idx(ix0, p.idx, pu, beg, end);
    stage_idx(ix1, p.idx, pu, beg + kP, end);
    stage_idx(ix2, p.idx, pu, beg + 2 * kP, end);
    stage_copy<kVec>(ring_s, yf, y_sr, ix0, qu, lane);
    stage_copy<kVec>(ring_s + kStageWords * 4, yf, y_sr, ix1, qu, lane);
    stage_copy<kVec>(ring_s + 2 * kStageWords * 4, yf, y_sr, ix2, qu, lane);
  }
  static_assert(kStages == 4, "the prologue fills kStages - 1 = 3 stages");
  int ix[kCopies], jx[kCopies];
  stage_idx(ix, p.idx, pu, beg + 3 * kP, end);
  stage_idx(jx, p.idx, pu, beg + 4 * kP, end);
  // the lane's place in a stage: its slot (a segment of partials) and
  // feature
  int Wp = 1;
  while (Wp < W) Wp *= 2;
  const int slot = lane / Wp;
  const int ft = lane % Wp;
  const int P = 32 / Wp;                 // segments of a stage
  Acc a = Fd::init();
  // plus_times of one feature folds its partials four at a time, 16-byte
  // words ("quads") of the stage, into one chain
  constexpr int kQ = kStageWords / 4;    // quads a stage
  const bool quads = kAlg == kPlusTimes && kVec == 1 && W == 1;
  Acc chain = Fd::init();
  for (int s = 0, c = beg; c < end; ++s, c += kP) {
    cp_async_wait<kStages - 2>();        // stage s landed (this lane's)
    __syncwarp();                        // and every lane's; s-1 folded
    const uint32_t next =
        ring_s + ((s + kStages - 1) % kStages) * kStageWords * 4;
    const In* buf = ring + (s % kStages) * kStageWords;
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    const int n = min(kP, end - c);
    if (quads && n == kP) {
      // a whole stage, unrolled: the lane's copies of stage s + 3 and
      // its idx loads of stage s + 5 go between the adds, in the slots
      // the chain leaves free, each quad read kAhead quads ahead
      uint4 q[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) q[k] = b4[k];
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const uint4 w4 = q[i % kAhead];
        if (i + kAhead < kQ) q[i % kAhead] = b4[i + kAhead];
        chain = chain_add<kAlg>(chain, w4.x);
        chain = chain_add<kAlg>(chain, w4.y);
        chain = chain_add<kAlg>(chain, w4.z);
        chain = chain_add<kAlg>(chain, w4.w);
        if (i % (kQ / kCopies) == 0) {
          const int k = i / (kQ / kCopies);
          if (ix[k] >= 0) {
            cp_async<4 * kVec>(next + (lane + 32 * k) * kVec * 4,
                               yf + ix[k] * y_sr + qu[k]);
          }
          ix[k] = jx[k];
          const int j = c + (kStages + 1) * kP + pu[k];
          jx[k] = pu[k] >= 0 && j < end ? __ldg(p.idx + j) : -1;
        }
      }
      cp_async_commit();
      continue;
    }
    stage_copy<kVec>(next, yf, y_sr, ix, qu, lane);
#pragma unroll
    for (int k = 0; k < kCopies; ++k) ix[k] = jx[k];
    stage_idx(jx, p.idx, pu, c + (kStages + 1) * kP, end);
    if constexpr (kAlg == kPlusTimes) {
      if (W == 1) {
        // the last, part-filled stage: four partials a quad
        const int n4 = n / 4;
        for (int i = 0; i < n4; ++i) chain = add4<kAlg, Acc, In>(chain, b4[i]);
        for (int j = n4 * 4; j < n; ++j) chain = Fd::add(chain, buf[j]);
      } else {
        // W > 1: lane ft < W folds feature ft (lanes past W repeat a
        // feature)
        const int fl = lane % W;
#pragma unroll 8
        for (int j = 0; j < n; ++j) a = Fd::add(a, buf[j * W + fl]);
      }
    } else {
      // slot s folds the stage's partials [s * sg, (s + 1) * sg) in order,
      // then the slots' folds combine as a tree whose left operand holds
      // the earlier segments (Q8.24 sums each lane's slots to the end)
      const int sg = (kP + P - 1) / P;
      const int j0 = slot * sg;
      Acc t = Fd::init();
      if (W == 1) {
        // the segment's kSeg partials as 16-byte words
        constexpr int kSeg = kStageWords / 32;
#pragma unroll
        for (int k = 0; k < kSeg; k += 4) {
          const uint4 u = b4[(j0 + k) / 4];
          const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j0 + k + e < n) t = Fd::add(t, Fd::word(v[e]));
          }
        }
      } else if (ft < W) {
        for (int k = 0; k < sg && j0 + k < n; ++k) {
          t = Fd::add(t, buf[(j0 + k) * W + ft]);
        }
      }
      if constexpr (kAlg == kFixed) {
        a += t;
      } else {
        for (int o = Wp; o < 32; o *= 2) {
          t = Fd::add(t, __shfl_down_sync(0xffffffffu, t, o));
        }
        a = Fd::add(a, t);
      }
    }
  }
  if (quads) a = chain;
  cp_async_wait<0>();                    // nothing in flight at exit
  if constexpr (kAlg == kFixed) {
    for (int o = Wp; o < 32; o *= 2) {
      a += __shfl_down_sync(0xffffffffu, static_cast<unsigned long long>(a),
                            o);
    }
  }
  if (lane < W) {
    static_cast<In*>(p.out)[r * p.o_sr + (f0 + lane) * p.o_sf] = Fd::done(a);
  }
}

template <int kAlg, int kMode>
__global__ void __launch_bounds__(kThreads) row_fold_kernel(const Params p) {
  using In = typename Fold<kAlg>::In;
  extern __shared__ __align__(16) uint32_t smem[];
  if (blockIdx.x < p.hub_blocks) {
    const int wl = threadIdx.x / 32;
    if (wl >= kHubWarps) return;
    fold_hub<kAlg, kMode>(p, blockIdx.x * int64_t{kHubWarps} + wl,
                          reinterpret_cast<In*>(smem) + wl * kRingWords);
  } else {
    fold_rows<kAlg, kMode>(
        p, (blockIdx.x - p.hub_blocks) * int64_t{kThreads} + threadIdx.x);
  }
}

template <int kAlg>
void launch(const Params& p, int mode, dim3 grid, size_t smem,
            cudaStream_t st) {
  if (mode == kOne) {
    row_fold_kernel<kAlg, kOne><<<grid, kThreads, smem, st>>>(p);
  } else if (mode == kInner) {
    row_fold_kernel<kAlg, kInner><<<grid, kThreads, smem, st>>>(p);
  } else {
    row_fold_kernel<kAlg, kInnerV4><<<grid, kThreads, smem, st>>>(p);
  }
}

// n dependent fp32 adds on one thread, timed with the SM's clock
__global__ void fadd_latency_kernel(float seed, int n, long long* cycles,
                                    float* sink) {
  float a = seed;
  const float b = seed * 0.5f;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) a = __fadd_rn(a, b);
  const long long t1 = clock64();
  *cycles = t1 - t0;
  *sink = a;
}

}  // namespace

// C entry point, loaded with ctypes (ops/_kernels.py).  inner = 1: y is
// (n_ren, F) and out (n_rows, F); inner = 0: y is (F, n_ren) and out (F,
// n_rows) (F = 1: vectors); both contiguous, float32, or Q8.24 uint32 words
// for alg 3.  idx, ptr (n_rows + 1,) and long_rows (n_long,; null when
// empty) int32 from ops/spmv.py:fold_plan, whose rows of more than
// thread_max partials long_rows lists.  alg: 0 plus_times, 1 min_plus,
// 2 max_times, 3 Q8.24.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, launching nothing, for arguments it refuses.
extern "C" int row_fold_launch(const void* y, const void* idx,
                               const void* ptr, const void* long_rows,
                               void* out, int n_rows, int n_long, int n_ren,
                               int F, int inner, int thread_max, int alg,
                               void* stream) {
  if (n_rows < 1 || n_long < 0 || F < 1 || n_ren < 0 || thread_max < 1 ||
      alg < 0 || alg > kFixed ||
      (inner != 0 && inner != 1) || (n_long > 0 && long_rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  inner = inner && F > 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int mode = !inner ? kOne : (F % 4 == 0 && aligned ? kInnerV4 : kInner);
  Params p{y, static_cast<const int32_t*>(idx),
           static_cast<const int32_t*>(ptr),
           static_cast<const int32_t*>(long_rows), out, n_rows, n_long, F,
           thread_max};
  if (inner) {
    p.y_sr = F, p.y_sf = 1, p.o_sr = F, p.o_sf = 1;
    p.n_fch = (F + kChunk - 1) / kChunk;
    p.n_hch = (F + kHubW - 1) / kHubW;
  } else {
    p.y_sr = 1, p.y_sf = n_ren, p.o_sr = 1, p.o_sf = n_rows;
    p.n_fch = F;
    p.n_hch = F;
  }
  const int64_t row_blocks =
      (static_cast<int64_t>(n_rows) * p.n_fch + kThreads - 1) / kThreads;
  p.hub_blocks = (static_cast<int64_t>(n_long) * p.n_hch + kHubWarps - 1) /
                 kHubWarps;
  if (row_blocks + p.hub_blocks > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(row_blocks + p.hub_blocks));
  // the hub warps' rings; CTAs of thread rows leave theirs unused
  const size_t smem = p.hub_blocks ? kHubWarps * kRingWords * 4 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alg == kPlusTimes) {
    launch<kPlusTimes>(p, mode, grid, smem, st);
  } else if (alg == kMinPlus) {
    launch<kMinPlus>(p, mode, grid, smem, st);
  } else if (alg == kMaxTimes) {
    launch<kMaxTimes>(p, mode, grid, smem, st);
  } else {
    launch<kFixed>(p, mode, grid, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The latency of one dependent fp32 add (the plus_times fold's chain):
// n adds on one thread; cycles (int64) gets the SM clocks they took, sink
// (float32) the sum.  Returns cudaGetLastError() after the launch.
extern "C" int fadd_latency_launch(void* cycles, void* sink, int n,
                                   float seed, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  fadd_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, n, static_cast<long long*>(cycles), static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}
