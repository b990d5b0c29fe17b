// Wavepack SpMV for Hopper (sm_90a): fp32 plus_times over a packed tile
// stream.
//
// Replaces the two TPU kernels of the main path, hisparse_tpu/ops/spmv.py:
// _resident_kernel and _paged_kernel (with their helpers _route_x,
// _tile_routed and _tile_body).  Resident versus paged was a VMEM budget
// of the TPU; here one kernel serves single- and multi-partition packs.
//
// What it computes.  For every accumulator slot (b, s, l) of row block b:
//
//   acc[b, s, l] = sum over the tiles t of b's run, in stream order, of
//                  vals'[t, s, l] * XT[part[t], blk, src, h]
//
// where src is the crossbar lane of dest slot (s, l) (the low 7 bits of
// the value with steal_mantissa, else bits 11..17 of the idx word of slot
// (s, l)), and h / blk come from the idx word of gather slot (s, src):
// h = w & 0x7F; the bank block is the b-field in select-chain packs, or
// class_map[t, s / 128, b-field] in block-major packs.  The idx word of
// gather slot (s, j) is stored transposed, at idxT[t, g*128 + j, s % 128]
// with g = s / 128 (formats/wavepack.py).  The decode is the masked one
// of the TPU interpret mode, not the compiled wrap-mod-128 one.
//
// The kernel gathers from XT, the (n_parts, CT, 128, 128) bank-block
// layout of x that SpmvOperator builds with build_xt (ops/spmv.py), so
// the two-choice rotated copies are ordinary blocks here.
//
// Mapping.  One thread per accumulator slot: a CTA owns kRows consecutive
// sublanes of one row block (kRows * 128 threads, lane l fastest) and walks
// that block's contiguous tile run.  No atomics, the same result every run,
// and each slot sums its terms in the TPU's sequential grid order.  For
// each tile the CTA first stages the kRows columns of the transposed idx
// words it needs (128 x kRows) in shared memory, so the crossbar lookup
// idx[src][s] is a shared-memory read.  Multiply and add are rounded
// separately (__fmul_rn, __fadd_rn), as the plain PyTorch version does.
//
// What bounds it.  Every slot of the stream is read once: 4 B of value
// plus 2 B (idx16) or 4 B of idx word, 6 B/slot with idx16.  XT and the
// tile metadata are small and stay in L2; the output is 4 B per slot of
// one tile.  So the stream's bytes over HBM bandwidth bound the kernel.
// The design reads values coalesced (128 consecutive floats per sublane)
// and reads each idx word once per CTA; its idx loads are kRows-element
// runs, which neighbouring CTAs of the same block complete in L2.  It
// does not yet overlap a tile's loads with the previous tile's compute
// (cp.async / TMA staging is later work).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 4;                 // sublanes per CTA
constexpr int kThreads = kRows * kLanes;

struct Params {
  const uint32_t* vals;                  // (T, S, 128) fp32 bits
  const void* idxT;                      // (T, S, 128) int16 or int32
  const int32_t* tile_part;              // (T,)
  const int32_t* cmap;                   // (T, S/128, K), block-major only
  const int32_t* run_start;              // (n_blocks,)
  const int32_t* run_end;                // (n_blocks,)
  const float* xt;                       // (n_parts, CT, 128, 128)
  float* out;                            // (n_blocks * S, 128)
  int S, n_ops, K, CT;
};

template <typename IdxT, bool kSteal, bool kBlockMajor>
__global__ void __launch_bounds__(kThreads)
wavepack_spmv_kernel(const Params p) {
  const uint32_t* __restrict__ vals = p.vals;
  const IdxT* __restrict__ idxT = static_cast<const IdxT*>(p.idxT);
  const int32_t* __restrict__ tile_part = p.tile_part;
  const int32_t* __restrict__ cmap = p.cmap;
  const float* __restrict__ xt = p.xt;
  const int S = p.S;
  const int chunks = S / kRows;
  const int b = blockIdx.x / chunks;
  const int s0 = (blockIdx.x % chunks) * kRows;
  const int g = s0 / kLanes;
  const int r0 = s0 % kLanes;
  const int rr = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int s = s0 + rr;
  const int G = S / kLanes;

  // sidx[j][q]: the packed idx word of gather slot (s0 + q, j)
  __shared__ int32_t sidx[kLanes][kRows];
  const int ld_j = threadIdx.x / kRows;
  const int ld_q = threadIdx.x % kRows;

  float acc = 0.0f;
  const int t_end = p.run_end[b];
  for (int t = p.run_start[b]; t < t_end; ++t) {
    const int64_t tile = static_cast<int64_t>(t) * S * kLanes;
    sidx[ld_j][ld_q] = static_cast<int32_t>(
        idxT[tile + static_cast<int64_t>(g * kLanes + ld_j) * kLanes + r0 +
             ld_q]);
    __syncthreads();

    uint32_t vbits = vals[tile + static_cast<int64_t>(s) * kLanes + l];
    int src;
    if (kSteal) {
      src = vbits & 0x7F;
      vbits &= 0xFFFFFF80u;
    } else {
      src = (sidx[l][rr] >> 11) & 0x7F;
    }
    const int32_t w = sidx[src][rr];
    const int h = w & 0x7F;
    int op;
    if (kSteal) {
      // the whole word is b*128 + h: the TPU select chain keeps the
      // highest operand i with w >= i*128
      op = min(max(w >> 7, 0), p.n_ops - 1);
    } else {
      op = (w >> 7) & 0xF;
      if (op >= p.n_ops) op = 0;
    }
    const int blk = kBlockMajor
                        ? cmap[(static_cast<int64_t>(t) * G + g) * p.K + op]
                        : op;
    const int part = tile_part[t];
    const float xv = xt[((static_cast<int64_t>(part) * p.CT + blk) * kLanes +
                           src) * kLanes + h];
    acc = __fadd_rn(acc, __fmul_rn(__uint_as_float(vbits), xv));
    __syncthreads();
  }
  p.out[(static_cast<int64_t>(b) * S + s) * kLanes + l] = acc;
}

template <typename IdxT>
void launch(const Params& p, int steal, int block_major, dim3 grid,
            cudaStream_t st) {
  if (steal && block_major)
    wavepack_spmv_kernel<IdxT, true, true><<<grid, kThreads, 0, st>>>(p);
  else if (steal)
    wavepack_spmv_kernel<IdxT, true, false><<<grid, kThreads, 0, st>>>(p);
  else if (block_major)
    wavepack_spmv_kernel<IdxT, false, true><<<grid, kThreads, 0, st>>>(p);
  else
    wavepack_spmv_kernel<IdxT, false, false><<<grid, kThreads, 0, st>>>(p);
}

}  // namespace

// C entry point, loaded with ctypes (ops/_kernels.py).  Shapes: vals and
// idxT (T, S, 128); tile_part (T,); cmap (T, S/128, K) or null; run_start
// and run_end (n_blocks,); xt (n_parts, CT, 128, 128); out (n_blocks*S,
// 128).  Returns cudaGetLastError() after the launch.
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
                 S, n_ops, K, CT};
  const dim3 grid(n_blocks * (S / kRows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx16)
    launch<int16_t>(p, steal, block_major, grid, st);
  else
    launch<int32_t>(p, steal, block_major, grid, st);
  return static_cast<int>(cudaGetLastError());
}
