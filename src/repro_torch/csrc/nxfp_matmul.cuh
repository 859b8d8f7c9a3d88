// The dequant GEMM's two regimes (nxfp_matmul_decode.cu, M <= 16, and
// nxfp_matmul_prefill.cu, M > 16), their launchers, and the W-decode
// helpers they share. nxfp_matmul.cu runs the regime its caller planned.
//
// Both regimes decode each W value exactly as _decode_tile does (decoded
// f32 element value times its block scale, or the ox/asym value, then
// round-to-nearest-even to bf16) straight into a register fragment of the
// tensor-core product; the decoded tile never touches shared memory.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nxfp_decode.cuh"

namespace nxfp {

// One W block's decode state: its scale (or, for an activation format,
// its per-sign scales and ox slot) and the byte offset of the LUT half its
// fmt bit selects. Codes come as byte offsets into the LUT (code * 4) in
// bits [2, BITS + 2) of a word whose other bits are ignored, so a caller
// shifts a packed word once and leaves the masking to one LOP3 here.
template <int BITS, bool EX>
struct WScale {
  __nv_bfloat162 sc2;  // symmetric formats: the block scale, twice
  BlockScale bs;
  unsigned fboff;
  bool ex;  // the format is asym or ox (uniform across a launch)

  __device__ __forceinline__ void set(unsigned meta, const FmtDesc& f) {
    ex = EX && (f.asym || f.ox);
    int fb;
    if (ex) {
      bs = block_scale(meta, f);
      fb = bs.fb;
    } else {
      // (1 + nano/4) * 2**E has 3 significant bits: exact in bf16
      sc2 = __float2bfloat162_rn(decode_scale(meta & 0xFFFFu, &fb));
    }
    fboff = (unsigned)fb << (BITS + 2);
  }

  static constexpr unsigned kOff = ((1u << BITS) - 1u) << 2;

  // The codes at byte offsets o0, o1 (positions i, i + 1 of the block) ->
  // one bf16 pair, position i in the low half. For a symmetric format
  // lut * scale is exact in f32 (at most 8 x 3 significant bits), so the
  // bf16 multiply rounds it once, to the nearest even, as
  // __floats2bfloat162_rn of the f32 product does.
  __device__ __forceinline__ unsigned pair(const float* lut, unsigned o0,
                                           unsigned o1, int i) const {
    const char* lb = reinterpret_cast<const char*>(lut);
    o0 &= kOff;
    o1 &= kOff;
    float v0 = *reinterpret_cast<const float*>(lb + (o0 | fboff));
    float v1 = *reinterpret_cast<const float*>(lb + (o1 | fboff));
    __nv_bfloat162 h;
    if (ex) {
      v0 = block_value(bs, v0, (int)(o0 >> 2), i, BITS);
      v1 = block_value(bs, v1, (int)(o1 >> 2), i + 1, BITS);
      h = __floats2bfloat162_rn(v0, v1);
    } else {
      h = __hmul2(__floats2bfloat162_rn(v0, v1), sc2);
    }
    return *reinterpret_cast<const unsigned*>(&h);
  }
};

// Code i of pb as a LUT byte offset (code * 4) in bits [2, BITS + 2), for
// WScale::pair: one shift when the code lies within one word.
template <int BITS, int QB>
__device__ __forceinline__ unsigned code_off(const PackedBlock<BITS, QB>& pb,
                                             int i) {
  const int p = i * BITS, sh = p & 31;
  if (sh + BITS > 32) return (unsigned)pb.code(i) << 2;
  const unsigned w = pb.w[p >> 5];
  return sh >= 2 ? w >> (sh - 2) : w << (2 - sh);
}

// Codes o and o + 1 (o even) of a block held in shared memory, as the low
// 2*BITS bits of the result (code o lowest).
template <int BITS>
__device__ __forceinline__ unsigned smem_code_pair(const uint8_t* blk, int o) {
  const int p = o * BITS, lo = p >> 3, off = p & 7;
  unsigned v = blk[lo];
  if (off + 2 * BITS > 8) v |= (unsigned)blk[lo + 1] << 8;
  if (off + 2 * BITS > 16) v |= (unsigned)blk[lo + 2] << 16;
  return (v >> off) & ((1u << (2 * BITS)) - 1u);
}

}  // namespace nxfp

// Launchers (host). Each returns a cudaError_t.
//
// Decode regime: grid (ceil(N / tile_n), splits); split s takes K blocks
// [s * chunk, min(KB, (s + 1) * chunk)). With splits > 1, ws holds
// splits * M * N f32 partials and counters one int per N tile, all 0.
// tile_n and the limits on M and the x slice: nxfp_matmul_decode_geometry.
int nxfp_matmul_decode(const void* x, const void* packed, const void* meta,
                       void* y, int M, int N, int KB, int splits, int chunk,
                       void* ws, void* counters, const nxfp::FmtDesc& fd,
                       cudaStream_t st);
// Prefill regime: grid (ceil(M / 128), ceil(N / 128)); x by TMA.
int nxfp_matmul_prefill(const void* x, const void* packed, const void* meta,
                        void* y, int M, int N, int KB,
                        const nxfp::FmtDesc& fd, cudaStream_t st);
// The regime its caller planned (nxfp_matmul.cu): the decode regime with
// that split plan when splits > 0, the prefill regime otherwise.
// fmt_desc points to W's nxfp::FmtDesc, stream is a cudaStream_t.
extern "C" int nxfp_matmul_launch(const void* x, const void* packed,
                                  const void* meta, void* y, int M, int N,
                                  int KB, const void* fmt_desc, int splits,
                                  int chunk, void* ws, void* counters,
                                  void* stream);
