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
// Mapping.  Nothing accumulates, so every slot is independent: one CTA per
// (tile, kRows-sublane chunk), kRows * 128 threads, one thread per slot.
// A CTA stages the transposed idx words of its sublanes in shared memory
// (route.cuh) for the crossbar lookup, as the SpMV kernel does.  A pack
// with one row block (both transformer-70 training packs) still gives
// T * S / kRows CTAs, where the SpMV kernel's one thread per accumulator
// slot gives only S / kRows.
//
// What bounds it.  Per slot it reads 4 B of mask, 2 B (idx16) or 4 B of
// idx word, 4 B of g_acc, 4 B of value (steal packs only) and writes 4 B:
// 14-18 B per slot of HBM traffic, coalesced along the lanes.  XT stays in
// L2.  The bytes over HBM bandwidth bound it; a bit mask in place of the
// float mask, or the mask folded into the steal bits, would cut 4 B/slot
// and is later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "route.cuh"

namespace {

using namespace wavepack;

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
  int S, n_ops, K, CT;
};

template <typename IdxT, bool kSteal, bool kBlockMajor>
__global__ void __launch_bounds__(kThreads)
wavepack_gradstream_kernel(const Params p) {
  const IdxT* __restrict__ idxT = static_cast<const IdxT*>(p.idxT);
  const int S = p.S;
  const int chunks = S / kRows;
  const int t = blockIdx.x / chunks;
  const int s0 = (blockIdx.x % chunks) * kRows;
  const int rr = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int s = s0 + rr;
  const int64_t tile = static_cast<int64_t>(t) * S * kLanes;
  const int64_t slot = tile + static_cast<int64_t>(s) * kLanes + l;

  __shared__ int32_t sidx[kLanes][kRows];
  stage_idx(sidx, idxT, tile, s0);
  __syncthreads();
  uint32_t vbits = kSteal ? p.vals[slot] : 0u;
  const int32_t* crow =
      kBlockMajor ? p.cmap + (static_cast<int64_t>(t) * (S / kLanes) +
                              s0 / kLanes) * p.K
                  : nullptr;
  const int off = route<kSteal, kBlockMajor>(vbits, sidx, rr, l, crow,
                                             p.n_ops);
  const float xv =
      p.xt[static_cast<int64_t>(p.tile_part[t]) * p.CT * kPage + off];
  const float g =
      p.g_acc[(static_cast<int64_t>(p.tile_block[t]) * S + s) * kLanes + l];
  p.out[slot] = __fmul_rn(__fmul_rn(g, xv), p.mask[slot]);
}

}  // namespace

// C entry point, loaded with ctypes (ops/_kernels.py).  Shapes: vals, idxT,
// mask and out (T, S, 128); tile_part and tile_block (T,); cmap
// (T, S/128, K) or null; g_acc (n_blocks*S, 128); xt (n_parts, CT, 128,
// 128).  Returns cudaGetLastError() after the launch.
extern "C" int wavepack_gradstream_f32(const void* vals, const void* idxT,
                                       int idx16, int steal, int block_major,
                                       const void* mask,
                                       const void* tile_part,
                                       const void* tile_block,
                                       const void* cmap, const void* g_acc,
                                       const void* xt, void* out, int T,
                                       int S, int n_ops, int K, int CT,
                                       void* stream) {
  if (S % kLanes != 0 || T < 1 || n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(vals), idxT,
                 static_cast<const float*>(mask),
                 static_cast<const int32_t*>(tile_part),
                 static_cast<const int32_t*>(tile_block),
                 static_cast<const int32_t*>(cmap),
                 static_cast<const float*>(g_acc),
                 static_cast<const float*>(xt), static_cast<float*>(out),
                 S, n_ops, K, CT};
  const dim3 grid(static_cast<unsigned>(T) * (S / kRows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(idx16, steal, block_major,
                           [&](auto idx, auto st_, auto bm) {
    wavepack_gradstream_kernel<decltype(idx), decltype(st_)::value,
                               decltype(bm)::value>
        <<<grid, kThreads, 0, st>>>(p);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
