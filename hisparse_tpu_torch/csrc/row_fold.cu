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
//   out[f, r] = fold over j = ptr[r] .. ptr[r+1] - 1, in ascending j, of
//               y[f, idx[j]], from the algebra's identity
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
// Mapping.  A row of up to thread_max partials (FOLD_THREAD_MAX in
// ops/spmv.py, 32; almost every row) folds on one thread, one thread per
// (f, row): 256-thread CTAs over the F * n_rows pairs.  A hub row (more,
// listed in long_rows) folds on one warp: the warp loads kU * 32 of its
// partials at once (coalesced idx reads, 32 gathers a load) into its
// shared-memory buffer, and lane 0 folds them in ascending order while
// the next chunk's partials and the idx words of the one after are in
// flight; the row's thread skips it.  The fold's chain of dependent adds
// reads shared memory, not shuffles, and waits on no load: 1,688 partials
// (googleplus's longest row) took 30 us through __shfl_sync and 21 us
// with one chunk in flight (idx, then gather, then fold).  The hub warps'
// CTAs follow the row CTAs in one grid.
//
// What bounds it.  y is read once (4 B a renamed row and feature), idx
// once a feature, out written once: bytes over HBM bandwidth, a few
// microseconds.  The longest hub row is the other floor: its partials
// fold one after another, one dependent add (and shuffle) each, since any
// other order changes a plus_times sum's bits.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 16;                   // partials a hub lane loads at once

constexpr int kPlusTimes = 0;            // the alg argument (ops/_kernels.py)
constexpr int kMinPlus = 1;
constexpr int kMaxTimes = 2;
constexpr int kFixed = 3;

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
};

struct Params {
  const void* y;                         // (F, n_ren) In
  const int32_t* idx;                    // (ptr[n_rows],)
  const int32_t* ptr;                    // (n_rows + 1,)
  const int32_t* long_rows;              // (n_long,)
  void* out;                             // (F, n_rows) In
  int n_rows, n_long, n_ren, F, thread_max;
  int64_t row_blocks;                    // CTAs of the thread rows
};

// idx[c + u*32 + lane] of the kU loads of a hub chunk from c (0 past end)
__device__ __forceinline__ void hub_idx(int (&ix)[kU],
                                        const int32_t* __restrict__ idx,
                                        int c, int end, int lane) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int j = c + u * 32 + lane;
    ix[u] = j < end ? __ldg(idx + j) : -1;
  }
}

// the partials at ix (the identity's bits where ix < 0; never folded)
template <typename In>
__device__ __forceinline__ void hub_gather(In (&v)[kU], const In* yf,
                                           const int (&ix)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) v[u] = ix[u] >= 0 ? __ldg(yf + ix[u]) : In{};
}

template <int kAlg>
__global__ void __launch_bounds__(kThreads) row_fold_kernel(const Params p) {
  using Fd = Fold<kAlg>;
  using In = typename Fd::In;
  const In* __restrict__ y = static_cast<const In*>(p.y);
  In* __restrict__ out = static_cast<In*>(p.out);
  if (blockIdx.x < p.row_blocks) {
    // one thread a (f, row)
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (i >= static_cast<int64_t>(p.F) * p.n_rows) return;
    const int f = static_cast<int>(i / p.n_rows);
    const int r = static_cast<int>(i % p.n_rows);
    const int beg = __ldg(p.ptr + r);
    const int end = __ldg(p.ptr + r + 1);
    if (end - beg > p.thread_max) return;  // a hub warp writes it
    const In* yf = y + static_cast<int64_t>(f) * p.n_ren;
    typename Fd::Acc a = Fd::init();
#pragma unroll 4
    for (int j = beg; j < end; ++j) {
      a = Fd::add(a, __ldg(yf + __ldg(p.idx + j)));
    }
    out[i] = Fd::done(a);
    return;
  }
  // one warp a (f, hub row): the lanes load kSpan partials at a time into
  // the warp's buffer, and lane 0 folds them in order
  constexpr int kSpan = kU * 32;
  __shared__ __align__(16) In buf[kWarps][kSpan];
  const int lane = threadIdx.x % 32;
  const int wl = threadIdx.x / 32;
  const int64_t w = (blockIdx.x - p.row_blocks) * kWarps + wl;
  if (w >= static_cast<int64_t>(p.F) * p.n_long) return;
  const int f = static_cast<int>(w / p.n_long);
  const int r = __ldg(p.long_rows + w % p.n_long);
  const int beg = __ldg(p.ptr + r);
  const int end = __ldg(p.ptr + r + 1);
  const In* yf = y + static_cast<int64_t>(f) * p.n_ren;
  // two chunks ahead of the fold: the idx words of chunk c + 2 and the
  // partials of chunk c + 1 are in flight while lane 0 folds chunk c
  int ix[kU];
  In v[kU];
  hub_idx(ix, p.idx, beg, end, lane);
  hub_gather(v, yf, ix);
  hub_idx(ix, p.idx, beg + kSpan, end, lane);
  typename Fd::Acc a = Fd::init();
  for (int c = beg; c < end; c += kSpan) {
    __syncwarp();                          // lane 0 is done with buf
#pragma unroll
    for (int u = 0; u < kU; ++u) buf[wl][u * 32 + lane] = v[u];
    __syncwarp();
    if (c + kSpan < end) {
      hub_gather(v, yf, ix);
      hub_idx(ix, p.idx, c + 2 * kSpan, end, lane);
    }
    if (lane == 0) {
      // 16-byte reads, four partials each, ahead of the chain of adds
      const int n = min(kSpan, end - c);
      const In* bw = buf[wl];
      int j = 0;
#pragma unroll 4
      for (; j + 4 <= n; j += 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(bw + j);
        a = Fd::add(Fd::add(Fd::add(Fd::add(a, Fd::word(q.x)),
                                    Fd::word(q.y)), Fd::word(q.z)),
                    Fd::word(q.w));
      }
      for (; j < n; ++j) a = Fd::add(a, bw[j]);
    }
  }
  if (lane == 0) {
    out[static_cast<int64_t>(f) * p.n_rows + r] = Fd::done(a);
  }
}

}  // namespace

// C entry point, loaded with ctypes (ops/_kernels.py).  y (F, n_ren) and
// out (F, n_rows): float32, or Q8.24 uint32 words for alg 3; idx, ptr
// (n_rows + 1,) and long_rows (n_long,; null when empty) int32 from
// ops/spmv.py:fold_plan, whose rows of more than thread_max partials
// long_rows lists.  alg: 0 plus_times, 1 min_plus, 2 max_times, 3 Q8.24.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue,
// launching nothing, for arguments it refuses.
extern "C" int row_fold_launch(const void* y, const void* idx,
                               const void* ptr, const void* long_rows,
                               void* out, int n_rows, int n_long, int n_ren,
                               int F, int thread_max, int alg,
                               void* stream) {
  if (n_rows < 1 || n_long < 0 || F < 1 || n_ren < 0 || thread_max < 1 ||
      alg < 0 || alg > kFixed || (n_long > 0 && long_rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_blocks =
      (static_cast<int64_t>(F) * n_rows + kThreads - 1) / kThreads;
  const int64_t hub_blocks =
      (static_cast<int64_t>(F) * n_long + kWarps - 1) / kWarps;
  if (row_blocks + hub_blocks > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{y, static_cast<const int32_t*>(idx),
                 static_cast<const int32_t*>(ptr),
                 static_cast<const int32_t*>(long_rows), out, n_rows, n_long,
                 n_ren, F, thread_max, row_blocks};
  const dim3 grid(static_cast<unsigned>(row_blocks + hub_blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alg == kPlusTimes) {
    row_fold_kernel<kPlusTimes><<<grid, kThreads, 0, st>>>(p);
  } else if (alg == kMinPlus) {
    row_fold_kernel<kMinPlus><<<grid, kThreads, 0, st>>>(p);
  } else if (alg == kMaxTimes) {
    row_fold_kernel<kMaxTimes><<<grid, kThreads, 0, st>>>(p);
  } else {
    row_fold_kernel<kFixed><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
