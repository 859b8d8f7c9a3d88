// The tile loop shared by the two GEMMs (nxfp_matmul.cu, nxfp_qq_matmul.cu).
//
// A block of kGemmThreads threads computes a BM x kBN tile of y (M, N) f32
// = x (M, K) . w (N, K)^T, stepping K by kBK: both tiles of a step are put
// in shared memory as bf16 (padded rows against bank conflicts), then each
// of the four warps runs mma.sync m16n8k16 bf16 -> f32 over its 16 columns
// for every m16 row tile, accumulating in registers.
#pragma once

#include <cuda_bf16.h>

#include "nxfp_decode.cuh"

namespace nxfp {

constexpr int kBN = 64;           // N tile
constexpr int kBK = 128;          // K step
constexpr int kPad = 8;           // bf16 row padding
constexpr int kGemmThreads = 128;

using TileRow = __nv_bfloat16[kBK + kPad];

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Decode a ROWS x kBK tile of a packed operand (ROWS rows from r0, kBK/QB
// blocks from kb0) into shared memory; rows or blocks past the end are 0.
// EX: the operand may be in an activation format (decode_block_bf16).
template <int ROWS, int BITS, int QB, bool EX>
__device__ __forceinline__ void decode_tile(TileRow* dst,
                                            const uint8_t* __restrict__ packed,
                                            const void* __restrict__ meta,
                                            int r0, int n_rows, int kb0,
                                            int KB, const float* lut,
                                            const FmtDesc& fd, int tid) {
  constexpr int kQPerRow = kBK / QB;
  for (int it = tid; it < ROWS * kQPerRow; it += kGemmThreads) {
    const int r = it / kQPerRow, j = it % kQPerRow;
    const int row = r0 + r, kb = kb0 + j;
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(&dst[r][j * QB]);
    if (row < n_rows && kb < KB) {
      decode_block_bf16<BITS, QB, EX>(packed, meta, (size_t)row * KB + kb, lut,
                                      fd, d);
    } else {
#pragma unroll
      for (int i = 0; i < QB; i += 2) d[i / 2] = __floats2bfloat162_rn(0.0f, 0.0f);
    }
  }
}

// acc += xs . ws^T over one K step, for this warp's 16 columns.
template <int BM>
__device__ __forceinline__ void mma_tile(const TileRow* xs, const TileRow* ws,
                                         float (&acc)[BM / 16][2][4], int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    unsigned bf[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int nr = warp * 16 + nt * 8 + g;
      bf[nt][0] = *reinterpret_cast<const unsigned*>(&ws[nr][ks + tq * 2]);
      bf[nt][1] = *reinterpret_cast<const unsigned*>(&ws[nr][ks + tq * 2 + 8]);
    }
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt) {
      const int r = mt * 16 + g;
      unsigned af[4];
      af[0] = *reinterpret_cast<const unsigned*>(&xs[r][ks + tq * 2]);
      af[1] = *reinterpret_cast<const unsigned*>(&xs[r + 8][ks + tq * 2]);
      af[2] = *reinterpret_cast<const unsigned*>(&xs[r][ks + tq * 2 + 8]);
      af[3] = *reinterpret_cast<const unsigned*>(&xs[r + 8][ks + tq * 2 + 8]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
    }
  }
}

// Write the accumulators of the tile at (m0, n0) to y, masking the edges.
template <int BM>
__device__ __forceinline__ void store_tile(float* __restrict__ y,
                                           const float (&acc)[BM / 16][2][4],
                                           int m0, int n0, int M, int N,
                                           int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = n0 + warp * 16 + nt * 8 + tq * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mt * 16 + g + h * 8;
        if (m >= M) continue;
        if (n < N) y[(size_t)m * N + n] = acc[mt][nt][2 * h];
        if (n + 1 < N) y[(size_t)m * N + n + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

}  // namespace nxfp
