// Wavepack routing, shared by every wavepack kernel (the SpMV / SpMM
// kernel of wavepack_spmv.cu and wavepack_gradstream.cu), so that their
// decodes cannot drift apart.  It is the CUDA form of the TPU helpers _route_x and
// _tile_routed (hisparse_tpu/ops/spmv.py), and of route_plain in
// hisparse_tpu_torch/ops/spmv.py.  bf16 and Q8.24 packs never steal
// mantissa bits (config.py), so they route as fp32 packs without
// steal_mantissa do.
//
// A CTA owns kRows consecutive sublanes s0 .. s0 + kRows - 1 of one tile
// (kRows * 128 threads, lane l fastest).  Per tile it stages the idx words
// those sublanes gather through in shared memory (stage_idx here, or the
// SpMV kernel's cp.async ring), then each thread routes its dest slot
// (s, l) (route):
//
//   src  the crossbar lane: the low 7 bits of the value with
//        steal_mantissa (the value's stolen bits are then cleared), else
//        bits 11..17 of the idx word of slot (s, l);
//   w    the idx word of gather slot (s, src), from the staged words;
//   h    w & 0x7F, the address in the bank block;
//   blk  the bank block: the b-field in select-chain packs, or
//        class_map[t, s / 128, b-field] in block-major packs.
//
// The routed x is XT[part, blk, src, h] of the (n_parts, CT, 128, 128)
// bank-block layout (build_xt in ops/spmv.py); route returns its offset
// inside one partition's (CT, 128, 128) page.  The idx word of gather slot
// (s, j) is stored transposed, at idxT[t, g*128 + j, s % 128] with
// g = s / 128 (formats/wavepack.py).  The decode is the masked one of the
// TPU interpret mode, not the compiled wrap-mod-128 one.
#pragma once

#include <cstdint>
#include <type_traits>

namespace wavepack {

constexpr int kLanes = 128;
constexpr int kRows = 4;                 // sublanes per CTA
constexpr int kThreads = kRows * kLanes;
constexpr int kPage = kLanes * kLanes;   // floats in one bank block

// sidx[j][q]: the idx word of gather slot (s0 + q, j) of the tile whose
// words start at idxT + tile_base.  Every thread of the CTA loads one
// word; the caller synchronises before reading sidx.
template <typename IdxT>
__device__ __forceinline__ void stage_idx(int32_t (&sidx)[kLanes][kRows],
                                          const IdxT* __restrict__ idxT,
                                          int64_t tile_base, int s0) {
  const int j = threadIdx.x / kRows;
  const int q = threadIdx.x % kRows;
  const int g = s0 / kLanes;
  sidx[j][q] = static_cast<int32_t>(
      idxT[tile_base + static_cast<int64_t>(g * kLanes + j) * kLanes +
           s0 % kLanes + q]);
}

// Offset of the routed x of dest slot (s0 + rr, l) inside one partition's
// XT page, for a CTA of kR sublanes (kRows here, 8 in the SpMV kernel).
// sidx holds the staged idx words (int32, or the raw int16 words
// of an idx16 pack, sign-extended here as the plain version widens them);
// crow the K class ids class_map[t, s0 / 128, :] of the tile's group
// (block-major packs only).  With kSteal, vbits (the slot's value bits)
// comes back with its stolen src bits cleared.
template <bool kSteal, bool kBlockMajor, typename W, int kR>
__device__ __forceinline__ int route(uint32_t& vbits,
                                     const W (&sidx)[kLanes][kR], int rr,
                                     int l, const int32_t* crow, int n_ops) {
  int src;
  if (kSteal) {
    src = vbits & 0x7F;
    vbits &= 0xFFFFFF80u;
  } else {
    src = (static_cast<int32_t>(sidx[l][rr]) >> 11) & 0x7F;
  }
  const int32_t w = static_cast<int32_t>(sidx[src][rr]);
  const int h = w & 0x7F;
  int op;
  if (kSteal) {
    // the whole word is b*128 + h: the TPU select chain keeps the highest
    // operand i with w >= i*128
    op = min(max(w >> 7, 0), n_ops - 1);
  } else {
    op = (w >> 7) & 0xF;
    if (op >= n_ops) op = 0;
  }
  const int blk = kBlockMajor ? crow[op] : op;
  return (blk * kLanes + src) * kLanes + h;
}

// Calls f(IdxT{}, bool_constant<steal>{}, bool_constant<block_major>{})
// for the run-time pack flags, so each kernel instantiates its template
// for the six kinds of pack that config.py allows, in one place; idx16
// needs steal_mantissa (an idx16 word has no room for src).  Returns false,
// calling nothing, for idx16 without steal.
template <typename F>
bool dispatch(bool idx16, bool steal, bool block_major, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (idx16) {
    if (!steal) return false;
    if (block_major) f(int16_t{}, T{}, T{});
    else f(int16_t{}, T{}, N{});
    return true;
  }
  if (steal && block_major) f(int32_t{}, T{}, T{});
  else if (steal) f(int32_t{}, T{}, N{});
  else if (block_major) f(int32_t{}, N{}, T{});
  else f(int32_t{}, N{}, N{});
  return true;
}

}  // namespace wavepack
