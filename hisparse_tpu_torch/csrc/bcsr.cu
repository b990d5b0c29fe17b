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
// Mapping, bf16.  A CTA owns half a block row's output rows (64 of 128)
// and kChunk = 64 columns: (2 nbr, ceil(kp / 64)) CTAs, 2 resident an SM
// (bcsr-spmm-16k: 256 CTAs on 132 SMs, where one CTA per block row gave
// 128).  It walks its block row's blocks in storage order and keeps the
// 64 x 64 output tile in the registers of one consumer warpgroup, written
// once: no atomics, the same result every run; each output folds its
// block row's blocks in the order of the plain version.  The TPU's
// accumulation in VMEM over a sequential grid (dimension_semantics=
// ("arbitrary",)) becomes this loop inside the CTA.
//
//   The ring.  kStages stages of 32 KB in dynamic shared memory, each the
//   CTA's 64 x 128 half block (two TMA boxes of 64 x 64, K-major) and the
//   block's 128 x 64 x slice (one box, N-contiguous), all with the 128-byte
//   swizzle.  One producer warp (warp 4, one thread) issues the three
//   cp.async.bulk.tensor loads of a stage once the consumers have freed it
//   (the stage's "empty" mbarrier) and arms its "full" mbarrier with the
//   32,768 bytes they bring; the tensor maps are encoded on the host
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   the library needs no -lcuda) and passed as __grid_constant__
//   parameters.  Up to kStages blocks are in flight while the tensor cores
//   work: 2 CTAs x 3 stages x 32 KB an SM.
//
//   The product.  The consumer warpgroup (warps 0-3) waits for a stage's
//   full barrier and runs 8 wgmma.mma_async m64n64k16 (bf16 in, fp32
//   accumulate) over the block's K = 128, A (the half block) and B (the x
//   slice, read through the transpose bit, as x is N-contiguous) from
//   shared memory, then waits for them and frees the stage.
//
//   Edges.  The last column chunk of kp = 8, 16 or 72 reads past x's
//   columns: TMA fills those with zeros, and the columns are not written.
//   A block row without blocks issues nothing and writes zeros.
//
// Mapping, fp32: one CTA per (block row, chunk of kC columns) with FFMA on
// the CUDA cores and no TF32 (the fp32 gate is 1e-4 against f64): thread
// (row i, column half h) keeps kC / 2 accumulators and folds j in
// ascending order, kC = 8 for kp = 8 and 64 otherwise; the block and its x
// slice staged one at a time.
//
// What bounds it.  At the main path's 64 right-hand sides the bf16 blocks
// (32 KB a block) are the bytes that count; their products need 64 FLOP a
// block byte (2 x 128 x 128 x 64 a block), under the card's bf16
// tensor-core ridge of about 295, so the blocks' bytes over HBM bandwidth
// bound it (bcsr-spmm-16k: 100.7 MB, 0.0319 ms at 3.35 TB/s); the ring
// keeps enough of them in flight.  fp32 on the CUDA cores is bound by its
// FFMAs (2 x 128 x 128 x kp a block at 67 TFLOP/s).  The earlier bf16
// kernel, one CTA a block row staging each block through registers with
// nothing in flight during its wmma products, reached 31% of the bound.
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBS = 128;                 // block edge
constexpr int kThreads = 256;            // fp32 kernel
constexpr int kLdF = kBS + 1;            // padded smem row of an fp32 block

// --- bf16: TMA ring + wgmma ------------------------------------------------
constexpr int kChunk = 64;               // columns a CTA
constexpr int kHalf = 64;                // output rows a CTA
constexpr int kStages = 3;
constexpr int kConsumers = 128;          // one warpgroup
constexpr int kBf16Threads = kConsumers + 32;   // + the producer warp
constexpr int kABox = kHalf * 64 * 2;    // bytes of one 64 x 64 A box
constexpr int kStageBytes = 2 * kABox + kBS * kChunk * 2;   // 32 KB
constexpr int kBf16Smem = kStages * kStageBytes + 1024 + 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` of barrier bar to complete.  A
// wait of more than about 10 s (2^34 clocks) traps: the launch then fails
// with an error where a lost arrival would hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// a 2-D box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte swizzle (layout type 1)
// at smem address addr: leading and stride byte offsets lbo, sbo.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// d += A B over one K = 16 step: A K-major, B MN-major (transposed)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the accumulators in their registers across the asynchronous
// wgmma (the compiler must not move them while the tensor cores write)
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kBf16Threads, 2)
bcsr_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_x,
                 const int32_t* __restrict__ brow_ptr,
                 const int32_t* __restrict__ bcol,
                 float* __restrict__ out, int kp) {
  extern __shared__ unsigned char smem_raw[];
  // the stages on a 1,024-byte boundary (the swizzle's atom), the
  // barriers after them
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int r = blockIdx.x / 2;
  const int h = blockIdx.x % 2;
  const int c0 = blockIdx.y * kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b0 = brow_ptr[r];
  const int nblk = brow_ptr[r + 1] - b0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer
    if (lane == 0) {
      for (int i = 0; i < nblk; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        const uint32_t st = base + s * kStageBytes;
        const int b = b0 + i;
        tma_load(st, &map_a, 0, b * kBS + h * kHalf, full(s));
        tma_load(st + kABox, &map_a, 64, b * kBS + h * kHalf, full(s));
        tma_load(st + 2 * kABox, &map_x, c0, bcol[b] * kBS, full(s));
      }
    }
    return;
  }

  // the consumers: 64 x 64 fp32 accumulators, 32 a thread
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  for (int i = 0; i < nblk; ++i) {
    const int s = i % kStages;
    mbar_wait(full(s), (i / kStages) & 1);
    const uint32_t st = base + s * kStageBytes;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBS / 16; ++kk) {
      // A: K-major, 8-row atoms 1,024 bytes apart, 32 bytes a K step in
      // the box of its half of K; B: MN-major, 8 K rows an atom, 2,048
      // bytes a K step
      const uint32_t a = st + (kk / 4) * kABox + (kk % 4) * 32;
      const uint32_t bx = st + 2 * kABox + kk * 2048;
      wgmma_m64n64k16(d, smem_desc(a, 16, 1024), smem_desc(bx, 1024, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(empty(s));
  }
  // the accumulator layout of wgmma m64nN: warp w holds rows 16w .. 16w+15;
  // register 4j + {0,1} row 16w + lane/4, 4j + {2,3} that row + 8, at
  // columns 8j + 2 (lane % 4) + {0, 1}
  const int row = h * kHalf + warp * 16 + lane / 4;
  float* o = out + (static_cast<int64_t>(r) * kBS + row) * kp + c0 +
             2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    if (c0 + 8 * j + 2 * (lane % 4) < kp) {
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(d[4 * j],
                                                          d[4 * j + 1]);
      *reinterpret_cast<float2*>(o + 8 * kp + 8 * j) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a bf16 row-major (rows, cols) tensor at ptr as 2-D boxes of (box_rows,
// 64) with the 128-byte swizzle, zeros past its edges
bool make_map(CUtensorMap* map, const void* ptr, uint64_t rows,
              uint64_t cols, uint32_t box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* blocks, const int32_t* brow_ptr,
                const int32_t* bcol, const void* x, float* out, int nbr,
                int nb, int nbc, int kp, cudaStream_t st) {
  CUtensorMap map_a, map_x;
  if (!make_map(&map_a, blocks, static_cast<uint64_t>(nb) * kBS, kBS,
                kHalf) ||
      !make_map(&map_x, x, static_cast<uint64_t>(nbc) * kBS, kp, kBS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        bcsr_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBf16Smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid(2 * nbr, (kp + kChunk - 1) / kChunk);
  bcsr_bf16_kernel<<<grid, kBf16Threads, kBf16Smem, st>>>(
      map_a, map_x, brow_ptr, bcol, out, kp);
  return static_cast<int>(cudaGetLastError());
}

// --- fp32: FFMA -------------------------------------------------------------
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
// x (x_rows, kp) of the blocks' type, x_rows = nbc*128; out (nbr*128, kp)
// fp32; kp a positive multiple of 8; blocks and x 16-byte aligned.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue,
// launching nothing, for shapes it refuses (and for a bf16 launch when
// cuTensorMapEncodeTiled cannot be looked up).
extern "C" int bcsr_spmm_launch(const void* blocks, int bf16,
                                const void* brow_ptr, const void* bcol,
                                const void* x, void* out, int nbr, int nb,
                                int x_rows, int kp, void* stream) {
  if (nbr < 1 || nb < 1 || x_rows < kBS || x_rows % kBS != 0 || kp < 8 ||
      kp % 8 != 0 || nbr > 0x3FFFFFFF || static_cast<int64_t>(nb) * kBS >
      0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* bp = static_cast<const int32_t*>(brow_ptr);
  const int32_t* bc = static_cast<const int32_t*>(bcol);
  float* o = static_cast<float*>(out);
  if (bf16) {
    return launch_bf16(blocks, bp, bc, x, o, nbr, nb, x_rows / kBS, kp, st);
  }
  const float* bl = static_cast<const float*>(blocks);
  const float* xf = static_cast<const float*>(x);
  return kp == 8 ? launch_f32<8>(bl, bp, bc, xf, o, nbr, kp, st)
                 : launch_f32<64>(bl, bp, bc, xf, o, nbr, kp, st);
}
