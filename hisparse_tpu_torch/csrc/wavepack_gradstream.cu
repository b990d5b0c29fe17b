// Wavepack gradient stream for Hopper (sm_90a): dL/dvals of a packed fp32
// plus_times SpMV, in the pack's own stream layout.
//
// Replaces the TPU kernel _gradstream_kernel (hisparse_tpu/ops/spmv.py,
// called through _gradstream_call), the backward of the stream-layout
// training path (ops/train_stream.py).
//
// What it computes.  For every slot (t, s, l) of the stream:
//
//   out[t, s, l] = g_acc[block[t] * S + s, l] * XT[part[t], blk, src, h]
//                  * mask[t, s, l]
//
// with (blk, src, h) the routing of slot (s, l) of tile t (route.cuh), the
// same routing the SpMV forward multiplies the value by.  g_acc is the
// output cotangent broadcast to the (n_blocks*S, 128) accumulator geometry
// (ops/train_stream.py:bcast_to_acc): the forward's accumulation is
// positional, so the row broadcast is a plain read of the slot's own
// accumulator position.  mask (0 or 1) zeroes the pad slots.  vals is read
// only for the stolen src bits of steal_mantissa packs.  The two products
// are rounded separately (__fmul_rn), in the order of the TPU kernel and of
// the plain version, so the result is bit-equal to both.
//
// What bounds it.  Per slot it reads 4 B of mask, 2 B (idx16) or 4 B of
// idx word, 4 B of value (steal packs only) and writes 4 B: 14-18 B a slot
// of HBM traffic; g_acc (one row block's worth on the training packs) and
// XT stay in L2.  The bytes over HBM bandwidth bound it (transformer-70's
// A pack: 5.37M slots, 75.2 MB, 0.0226 ms at 3.35 TB/s).
//
// Mapping.  Nothing accumulates, so the slots are independent.  The work
// is cut into items of kR = 32 consecutive sublanes of one tile (4,096
// slots), so each of the 128 idx rows an item's crossbar lookups read is
// 64 (idx16) or 128 contiguous bytes of the transposed idx words.  A grid
// of as many CTAs as the SMs hold (two an SM, 256 threads, a ring of 84
// KB for idx16) walks the items with a stride of the grid, so the CTAs
// that run side by side read neighbouring items (the quarters of the same
// idx rows); a thread owns 4 adjacent lanes of a sublane and 4 such quads
// an item: its value, mask and g_acc reads and its store are 16 bytes
// each.  A cp.async ring of kStages = 2 items brings the next item's
// values, mask, idx rows, class-map row and tile words into shared memory
// while the current one routes and gathers; one barrier an item both
// publishes item n and frees the stage item n + 1 reuses, the discipline
// of wavepack_spmv.cu.  The idx rows are padded (8 bytes a row) so that a
// warp's lookups, one sublane at random lanes, spread over the
// shared-memory banks.  XT (a few MB, in L2) is gathered through L1.
// utils/parent_ab.py --sweep timed the choices on the transformer-70
// packs (PERF.md): the gathers cost about an eighth of the A pack's time,
// yet a variant that kept the XT page in shared memory was no faster;
// contiguous item ranges were slower than the stride of the grid, and a
// ring of 3 or 4 items, or 512-thread CTAs, no faster on both packs.  The
// earlier design, one short CTA per (tile, 4 sublanes) that staged its
// idx words by hand, read each idx row as a quarter of a sector and
// reached 1.6 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

#include "route.cuh"

namespace {

using namespace wavepack;

constexpr int kR = 32;                   // sublanes an item
constexpr int kGThreads = 256;           // threads a CTA
constexpr int kQuads = kR * kLanes / 4;  // 4-lane quads an item
constexpr int kPerThread = kQuads / kGThreads;
constexpr int kStages = 2;               // the ring: 1 item in flight
constexpr int kMaxK = 8;                 // classes_per_group (config.py)
static_assert(kQuads % kGThreads == 0, "whole quads a thread");

struct Params {
  const uint32_t* vals;                  // (T, S, 128) fp32 bits
  const void* idxT;                      // (T, S, 128) int16 or int32
  const float* mask;                     // (T, S, 128)
  const int32_t* tile_part;              // (T,)
  const int32_t* tile_block;             // (T,)
  const int32_t* cmap;                   // (T, S/128, K), block-major only
  const float* g_acc;                    // (n_blocks * S, 128)
  const float* xt;                       // (n_parts, CT, 128, 128)
  float* out;                            // (T, S, 128)
  int T, S, n_ops, K, CT;
};

// An idx row in shared memory: kR words and 8 bytes of padding (rows of
// 72 or 136 bytes, 8-byte aligned for the copies), so that one sublane's
// words at random lanes fall in 16 banks, not 2 or 1.
template <typename IdxT>
constexpr int row_words() { return sizeof(IdxT) == 2 ? kR + 4 : kR + 2; }

// One stage of the ring: what a CTA reads of one item (tile t, sublanes
// s0 .. s0 + kR - 1).
template <typename IdxT, bool kSteal>
struct __align__(16) Stage {
  uint32_t vals[kSteal ? kR * kLanes : 4];   // vals[t, s0 + q, l] at q*128+l
  float mask[kR * kLanes];
  IdxT idx[kLanes][row_words<IdxT>()];       // idx[j][q]: slot (s0 + q, j)
  int32_t cmap[kMaxK];                       // class_map[t, s0 / 128, :]
  int32_t part, block;                       // tile_part[t], tile_block[t]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copies bypass L1 (.cg); 4- and 8-byte ones go through it
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issues the copies of item `item` into stage st, every thread a share.
template <typename IdxT, bool kSteal, bool kBlockMajor>
__device__ __forceinline__ void issue(Stage<IdxT, kSteal>& st,
                                      const Params& p, int item) {
  const int chunks = p.S / kR;
  const int t = item / chunks;
  const int s0 = (item % chunks) * kR;
  const int tid = threadIdx.x;
  const int64_t slot0 = (static_cast<int64_t>(t) * p.S + s0) * kLanes;
  // values and mask: kR * 128 contiguous words each, 16 B a copy
  constexpr int kChunks16 = kR * kLanes / 4;
#pragma unroll
  for (int c = tid; c < kChunks16; c += kGThreads) {
    if constexpr (kSteal) {
      cp_async<16>(st.vals + 4 * c, p.vals + slot0 + 4 * c);
    }
    cp_async<16>(st.mask + 4 * c, p.mask + slot0 + 4 * c);
  }
  // idx rows: row j is kR words at idxT[t, (s0/128)*128 + j, s0 % 128 ..]
  constexpr int kPerRow = kR * static_cast<int>(sizeof(IdxT)) / 8;
  const IdxT* idx = static_cast<const IdxT*>(p.idxT) +
                    static_cast<int64_t>(t) * p.S * kLanes +
                    static_cast<int64_t>(s0 / kLanes) * kLanes * kLanes +
                    s0 % kLanes;
#pragma unroll
  for (int c = tid; c < kLanes * kPerRow; c += kGThreads) {
    const int j = c / kPerRow;
    const int w = (c % kPerRow) * (8 / static_cast<int>(sizeof(IdxT)));
    cp_async<8>(&st.idx[j][w], idx + j * kLanes + w);
  }
  if (tid < kMaxK) {
    if (kBlockMajor && tid < p.K) {
      cp_async<4>(&st.cmap[tid],
                  p.cmap + (static_cast<int64_t>(t) * (p.S / kLanes) +
                            s0 / kLanes) * p.K + tid);
    }
  } else if (tid == kMaxK) {
    cp_async<4>(&st.part, p.tile_part + t);
  } else if (tid == kMaxK + 1) {
    cp_async<4>(&st.block, p.tile_block + t);
  }
}

// the n-th item of this CTA: a stride of the grid
__device__ __forceinline__ int item_of(int n) {
  return blockIdx.x + n * gridDim.x;
}

template <typename IdxT, bool kSteal, bool kBlockMajor>
__global__ void __launch_bounds__(kGThreads, 2)
wavepack_gradstream_kernel(const Params p) {
  using St = Stage<IdxT, kSteal>;
  constexpr int kAhead = kStages - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  St* ring = reinterpret_cast<St*>(smem);
  const int chunks = p.S / kR;
  const int n_items = p.T * chunks;
  const int n_mine =
      blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k < n_mine) issue<IdxT, kSteal, kBlockMajor>(ring[k], p, item_of(k));
    cp_async_commit();
  }
  for (int n = 0, cur = 0; n < n_mine;
       ++n, cur = cur + 1 == kStages ? 0 : cur + 1) {
    // item n has landed, and every thread is done with item n - 1, whose
    // stage the next copy reuses
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    if (n + kAhead < n_mine) {
      issue<IdxT, kSteal, kBlockMajor>(
          ring[cur == 0 ? kStages - 1 : cur - 1], p, item_of(n + kAhead));
    }
    cp_async_commit();
    const St& st = ring[cur];
    const int item = item_of(n);
    const int t = item / chunks;
    const int s0 = (item % chunks) * kR;
    const float* xt = p.xt + static_cast<int64_t>(st.part) * p.CT * kPage;
    // the g_acc rows first: their L2 latency overlaps the routing
    float4 g[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int q = threadIdx.x + k * kGThreads;
      g[k] = __ldg(reinterpret_cast<const float4*>(
          p.g_acc + (static_cast<int64_t>(st.block) * p.S + s0 +
                     q / (kLanes / 4)) * kLanes + 4 * (q % (kLanes / 4))));
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int q = threadIdx.x + k * kGThreads;
      const int rr = q / (kLanes / 4);         // a warp: one sublane
      const int l0 = 4 * (q % (kLanes / 4));
      const int e = rr * kLanes + l0;          // the quad in the item
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kSteal) v = *reinterpret_cast<const uint4*>(st.vals + e);
      const float4 m = *reinterpret_cast<const float4*>(st.mask + e);
      uint32_t vb[4] = {v.x, v.y, v.z, v.w};
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = route<kSteal, kBlockMajor>(vb[i], st.idx, rr, l0 + i,
                                                   st.cmap, p.n_ops);
        xv[i] = __ldg(xt + off);
      }
      const float4 o = make_float4(__fmul_rn(__fmul_rn(g[k].x, xv[0]), m.x),
                                   __fmul_rn(__fmul_rn(g[k].y, xv[1]), m.y),
                                   __fmul_rn(__fmul_rn(g[k].z, xv[2]), m.z),
                                   __fmul_rn(__fmul_rn(g[k].w, xv[3]), m.w));
      __stcs(reinterpret_cast<float4*>(
                 p.out + (static_cast<int64_t>(t) * p.S + s0) * kLanes + e),
             o);
    }
  }
}

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

// Launches one instantiation on a grid of as many CTAs as the SMs hold
// (at most one an item); sets its dynamic shared memory and reads its
// occupancy at the first launch.
template <typename IdxT, bool kSteal, bool kBlockMajor>
cudaError_t launch(const Params& p, cudaStream_t st) {
  auto kernel = wavepack_gradstream_kernel<IdxT, kSteal, kBlockMajor>;
  constexpr int kSmem =
      kStages * static_cast<int>(sizeof(Stage<IdxT, kSteal>));
  static int ctas_per_sm = 0;
  if (ctas_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel,
                                                        kGThreads, kSmem);
    }
    if (e != cudaSuccess) return e;
    if (ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const int64_t n_items = static_cast<int64_t>(p.T) * (p.S / kR);
  const int64_t full = static_cast<int64_t>(sm_count()) * ctas_per_sm;
  const int grid = static_cast<int>(n_items < full ? n_items : full);
  kernel<<<grid, kGThreads, kSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes (ops/_kernels.py).  Shapes: vals, idxT,
// mask and out (T, S, 128), vals, mask and g_acc 16-byte aligned;
// tile_part and tile_block (T,); cmap (T, S/128, K) or null; g_acc
// (n_blocks*S, 128); xt (n_parts, CT, 128, 128).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, launching
// nothing, for operands it refuses.
extern "C" int wavepack_gradstream_f32(const void* vals, const void* idxT,
                                       int idx16, int steal, int block_major,
                                       const void* mask,
                                       const void* tile_part,
                                       const void* tile_block,
                                       const void* cmap, const void* g_acc,
                                       const void* xt, void* out, int T,
                                       int S, int n_ops, int K, int CT,
                                       void* stream) {
  if (S % kLanes != 0 || S < kLanes || T < 1 || n_ops < 1 ||
      (block_major && (K < 1 || K > kMaxK)) ||
      static_cast<int64_t>(T) * (S / kR) > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(vals), idxT,
                 static_cast<const float*>(mask),
                 static_cast<const int32_t*>(tile_part),
                 static_cast<const int32_t*>(tile_block),
                 static_cast<const int32_t*>(cmap),
                 static_cast<const float*>(g_acc),
                 static_cast<const float*>(xt), static_cast<float*>(out),
                 T, S, n_ops, K, CT};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const bool ok = dispatch(idx16, steal, block_major,
                           [&](auto idx, auto st_, auto bm) {
    e = launch<decltype(idx), decltype(st_)::value, decltype(bm)::value>(
        p, st);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}
