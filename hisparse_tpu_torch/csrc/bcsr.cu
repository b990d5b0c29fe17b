// BCSR SpMM for Hopper (sm_90a): Y = A X over the dense 128 x 128 blocks
// of a block-sparse matrix, for kp right-hand sides, accumulated in fp32.
//
// Replaces the TPU kernel _bcsr_kernel (hisparse_tpu/ops/bcsr.py, called
// through _bcsr_call), the BCSR arm of the format dispatch
// (ops/dense.py:choose_format, ops/bcsr.py:BcsrOperator).
//
// What it computes.  For every block row r and column c < kp:
//
//   out[r*128 + i, c] = sum over the stored blocks b of block row r, in
//                       storage order (ascending block column), of
//                       sum_j blocks[b, i, j] * x[bcol[b]*128 + j, c]
//
// from 0, in fp32.  The blocks and x are both bf16 or both fp32 (the
// wrapper casts x to the blocks' type, as _bcsr_call does); out is fp32.
// A block row without blocks comes out at 0.  Block row r's blocks are the
// contiguous run [brow_ptr[r], brow_ptr[r+1]) of the block arrays.
//
// Mapping.  One CTA per (block row, chunk of kChunk columns) walks its
// block row's run in order, keeps the 128 x kChunk output tile in
// registers and writes it once: no atomics, the same result every run.
// The TPU's accumulation in VMEM over a sequential grid
// (dimension_semantics=("arbitrary",)) becomes this loop inside the CTA.
// Per block the CTA stages the block and its x slice in shared memory,
// then multiplies:
//
//   bf16  on the tensor cores (nvcuda::wmma, m16n16k16 bf16 -> fp32):
//         8 warps, warp w owning rows 16w .. 16w+15 and kChunk / 16
//         accumulator fragments;
//   fp32  with FFMA on the CUDA cores and no TF32 (the fp32 gate is 1e-4
//         against f64): thread (row i, column half h) keeps kC / 2
//         accumulators and folds j in ascending order, kC = 8 for kp = 8
//         and 64 otherwise.
//
// Columns past kp in the last chunk load as zeros and are not written.
//
// What bounds it.  At the main path's 64 right-hand sides the bf16 blocks
// (32 KB a block) are the bytes that count; their products need 64 FLOP a
// block byte (2 x 128 x 128 x 64 a block), under the card's bf16
// tensor-core ridge of about 295, so the blocks' bytes over HBM bandwidth
// bound it.  fp32 on the CUDA
// cores is bound by its FFMAs (2 x 128 x 128 x kp a block at 67 TFLOP/s).
// This first kernel stages one block at a time and does not overlap a
// block's loads with the previous block's products; with one CTA per block
// row a matrix of few block rows leaves SMs idle.  cp.async / TMA double
// buffering and wgmma are later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kBS = 128;                 // block edge
constexpr int kThreads = 256;
constexpr int kChunk = 64;               // columns a CTA (bf16)
constexpr int kLdA = kBS + 8;            // padded smem row of a bf16 block
constexpr int kLdX = kChunk + 8;         // padded smem row of an x slice
constexpr int kLdOut = kChunk + 4;       // fp32 staging row of the output
constexpr int kSmemBf16 =
    (kBS * kLdA + kBS * kLdX) * static_cast<int>(sizeof(__nv_bfloat16));
constexpr int kLdF = kBS + 1;            // padded smem row of an fp32 block

__global__ void __launch_bounds__(kThreads)
bcsr_bf16_kernel(const __nv_bfloat16* __restrict__ blocks,
                 const int32_t* __restrict__ brow_ptr,
                 const int32_t* __restrict__ bcol,
                 const __nv_bfloat16* __restrict__ x,
                 float* __restrict__ out, int kp) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);   // [128][kLdA]
  __nv_bfloat16* sX = sA + kBS * kLdA;                          // [128][kLdX]
  float* sOut = reinterpret_cast<float*>(smem);                 // [128][kLdOut]
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kChunk / 16];
#pragma unroll
  for (int n = 0; n < kChunk / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  const int b_end = brow_ptr[r + 1];
  for (int b = brow_ptr[r]; b < b_end; ++b) {
    // the block, 16 B (8 values) a load, rows of 16 loads
    const uint4* src =
        reinterpret_cast<const uint4*>(blocks + static_cast<int64_t>(b) *
                                                    kBS * kBS);
    for (int q = threadIdx.x; q < kBS * kBS / 8; q += kThreads) {
      const int row = q / (kBS / 8);
      const int col = (q % (kBS / 8)) * 8;
      *reinterpret_cast<uint4*>(sA + row * kLdA + col) = src[q];
    }
    // its x slice: rows bcol*128 .., columns c0 .. c0 + kChunk
    const __nv_bfloat16* xb = x + static_cast<int64_t>(bcol[b]) * kBS * kp;
    for (int q = threadIdx.x; q < kBS * kChunk / 8; q += kThreads) {
      const int row = q / (kChunk / 8);
      const int col = (q % (kChunk / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + col < kp) {
        v = *reinterpret_cast<const uint4*>(
            xb + static_cast<int64_t>(row) * kp + c0 + col);
      }
      *reinterpret_cast<uint4*>(sX + row * kLdX + col) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, sA + warp * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int n = 0; n < kChunk / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bx;
        wmma::load_matrix_sync(bx, sX + kk * kLdX + n * 16, kLdX);
        wmma::mma_sync(acc[n], a, bx, acc[n]);
      }
    }
    __syncthreads();
  }
  // stage the tile in shared memory (over the block buffers, which the
  // last __syncthreads freed) so the ragged last chunk writes only c < kp
#pragma unroll
  for (int n = 0; n < kChunk / 16; ++n) {
    wmma::store_matrix_sync(sOut + warp * 16 * kLdOut + n * 16, acc[n],
                            kLdOut, wmma::mem_row_major);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kBS * kChunk; q += kThreads) {
    const int row = q / kChunk;
    const int col = q % kChunk;
    if (c0 + col < kp) {
      out[(static_cast<int64_t>(r) * kBS + row) * kp + c0 + col] =
          sOut[row * kLdOut + col];
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
bcsr_f32_kernel(const float* __restrict__ blocks,
                const int32_t* __restrict__ brow_ptr,
                const int32_t* __restrict__ bcol,
                const float* __restrict__ x, float* __restrict__ out,
                int kp) {
  constexpr int kPer = kC / 2;           // columns a thread
  extern __shared__ __align__(16) float fsmem[];
  float* sA = fsmem;                     // [128][kLdF]
  float* sX = fsmem + kBS * kLdF;        // [128][kC]
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kC;
  const int i = threadIdx.x % kBS;       // the thread's row of the tile
  const int h = threadIdx.x / kBS;       // and its half of the columns

  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.0f;

  const int b_end = brow_ptr[r + 1];
  for (int b = brow_ptr[r]; b < b_end; ++b) {
    const float4* src = reinterpret_cast<const float4*>(
        blocks + static_cast<int64_t>(b) * kBS * kBS);
    for (int q = threadIdx.x; q < kBS * kBS / 4; q += kThreads) {
      const float4 v = src[q];
      float* d = sA + (q / (kBS / 4)) * kLdF + (q % (kBS / 4)) * 4;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    const float* xb = x + static_cast<int64_t>(bcol[b]) * kBS * kp;
    for (int q = threadIdx.x; q < kBS * kC / 4; q += kThreads) {
      const int row = q / (kC / 4);
      const int col = (q % (kC / 4)) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c0 + col < kp) {
        v = *reinterpret_cast<const float4*>(
            xb + static_cast<int64_t>(row) * kp + c0 + col);
      }
      *reinterpret_cast<float4*>(sX + row * kC + col) = v;
    }
    __syncthreads();
    const float* xr = sX + h * kPer;
    for (int j = 0; j < kBS; ++j) {
      const float a = sA[i * kLdF + j];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        acc[c] = __fmaf_rn(a, xr[j * kC + c], acc[c]);
      }
    }
    __syncthreads();
  }
  float* o = out + (static_cast<int64_t>(r) * kBS + i) * kp + c0 + h * kPer;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    if (c0 + h * kPer + c < kp) o[c] = acc[c];
  }
}

template <int kC>
int launch_f32(const float* blocks, const int32_t* brow_ptr,
               const int32_t* bcol, const float* x, float* out, int nbr,
               int kp, cudaStream_t st) {
  const int smem = (kBS * kLdF + kBS * kC) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      bcsr_f32_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nbr, (kp + kC - 1) / kC);
  bcsr_f32_kernel<kC><<<grid, kThreads, smem, st>>>(blocks, brow_ptr, bcol,
                                                     x, out, kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes (ops/_kernels.py).  blocks (nb, 128,
// 128) bf16 (bf16 != 0) or fp32; brow_ptr (nbr + 1,) and bcol (nb,) int32;
// x (nbc*128, kp) of the blocks' type; out (nbr*128, kp) fp32; kp a
// positive multiple of 8.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, launching nothing, for shapes it refuses.
extern "C" int bcsr_spmm_launch(const void* blocks, int bf16,
                                const void* brow_ptr, const void* bcol,
                                const void* x, void* out, int nbr, int kp,
                                void* stream) {
  if (nbr < 1 || kp < 8 || kp % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* bp = static_cast<const int32_t*>(brow_ptr);
  const int32_t* bc = static_cast<const int32_t*>(bcol);
  float* o = static_cast<float*>(out);
  if (bf16) {
    cudaError_t e = cudaFuncSetAttribute(
        bcsr_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBf16);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(nbr, (kp + kChunk - 1) / kChunk);
    bcsr_bf16_kernel<<<grid, kThreads, kSmemBf16, st>>>(
        static_cast<const __nv_bfloat16*>(blocks), bp, bc,
        static_cast<const __nv_bfloat16*>(x), o, kp);
    return static_cast<int>(cudaGetLastError());
  }
  const float* bl = static_cast<const float*>(blocks);
  const float* xf = static_cast<const float*>(x);
  return kp == 8 ? launch_f32<8>(bl, bp, bc, xf, o, nbr, kp, st)
                 : launch_f32<64>(bl, bp, bc, xf, o, nbr, kp, st);
}
