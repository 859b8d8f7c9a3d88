// Fused dequant GEMM: y (M, N) f32 = bf16(x) (M, K) @ dequant(Wq)^T.
//
// Replaces: src/repro/kernels/nxfp_matmul.py:nxfp_matmul_pallas (bodies
// _kernel and _decode_tile).
//
// Wq is stored packed (N, KB, bpb) uint8 + (N, KB) uint16 meta: for each
// output column n the K axis is contiguous, KB blocks of 32 codes. Each
// block's tile of W is decoded once into shared memory as bf16, rounded
// exactly as _decode_tile does (decoded f32 value times the block scale,
// both exact, then round-to-nearest-even to bf16), and reused by every row
// of the block's M tile. The product runs on the tensor cores
// (mma.sync m16n8k16 bf16 -> f32), accumulating in f32 registers.
//
// Bound on the H100: at decode (M = batch, a few rows) the packed weight
// bytes, ~4.5 bits per weight: a Llama-3-8B step streams 3.9 GB, >= 1.17 ms
// at 3.35 TB/s. At prefill (M = 512) the bf16 tensor-core FLOPs, 2*M*N*K.
// Design for that: one kernel for every M. The M tile is 16 rows when
// M <= 16 (decode pays for at most 16 rows of MMA, not 128) and 64 rows
// otherwise; the N tile is 64 columns, the K step 128. Neighbouring threads
// decode neighbouring packed blocks of one column (contiguous bytes). There
// is no split-K and no copy/compute overlap (no cp.async/TMA pipeline), so
// narrow-N projections at decode leave most SMs idle and each K step waits
// out its load latency: that is the first thing to make faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nxfp_decode.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 128;
constexpr int kPad = 8;
constexpr int kThreads = 128;

struct MatFmt {
  nxfp::ElemDesc elem[2];  // decode for fmt_bit 0 / 1 (equal when not AM)
};

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BITS, int QB>
__global__ void __launch_bounds__(kThreads)
nxfp_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ packed,
                   const uint16_t* __restrict__ meta, float* __restrict__ y,
                   int M, int N, int KB, MatFmt mf) {
  constexpr int kBpb = QB * BITS / 8;
  constexpr int kWords = (QB * BITS + 31) / 32;
  constexpr int kQPerRow = kBK / QB;           // packed blocks per tile row
  constexpr int kMT = BM / 16;                 // m16 tiles per block
  __shared__ __align__(16) __nv_bfloat16 xs[BM][kBK + kPad];
  __shared__ __align__(16) __nv_bfloat16 ws[kBN][kBK + kPad];
  __shared__ float lut[2][1 << BITS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int K = KB * QB;

  for (int i = tid; i < 2 << BITS; i += kThreads)
    lut[i >> BITS][i & ((1 << BITS) - 1)] =
        nxfp::decode_elem(i & ((1 << BITS) - 1), mf.elem[i >> BITS]);

  float acc[kMT][2][4];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // previous tile consumed (and the LUT written)
    // x tile: BM x kBK bf16, 8 values (16 bytes) per load; K is a multiple
    // of 16, so a chunk is either wholly inside K or wholly past it
    for (int c = tid; c < BM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + kc < K)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(&xs[r][kc]) = v;
    }
    // W tile: kBN columns x kQPerRow packed blocks, one block per item
    for (int it = tid; it < kBN * kQPerRow; it += kThreads) {
      const int nr = it / kQPerRow, j = it % kQPerRow;
      const int n = n0 + nr, kb = k0 / QB + j;
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(&ws[nr][j * QB]);
      if (n < N && kb < KB) {
        const size_t blk = (size_t)n * KB + kb;
        unsigned words[kWords];
        if constexpr (kBpb % 4 == 0) {
          const unsigned* src =
              reinterpret_cast<const unsigned*>(packed + blk * kBpb);
#pragma unroll
          for (int w = 0; w < kWords; ++w) words[w] = src[w];
        } else {
          const uint8_t* src = packed + blk * kBpb;
#pragma unroll
          for (int w = 0; w < kWords; ++w) words[w] = 0u;
#pragma unroll
          for (int b = 0; b < kBpb; ++b)
            words[b >> 2] |= (unsigned)src[b] << ((b & 3) * 8);
        }
        int fb;
        const float scale = nxfp::decode_scale((int)meta[blk], &fb);
        const float* lt = lut[fb];
#pragma unroll
        for (int i = 0; i < QB; i += 2) {
          int code[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int p = (i + u) * BITS;
            unsigned w = words[p >> 5] >> (p & 31);
            if ((p & 31) + BITS > 32) w |= words[(p >> 5) + 1] << (32 - (p & 31));
            code[u] = (int)(w & ((1u << BITS) - 1));
          }
          dst[i / 2] = __floats2bfloat162_rn(lt[code[0]] * scale,
                                             lt[code[1]] * scale);
        }
      } else {
#pragma unroll
        for (int i = 0; i < QB; i += 2)
          dst[i / 2] = __floats2bfloat162_rn(0.0f, 0.0f);
      }
    }
    __syncthreads();

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
      for (int mt = 0; mt < kMT; ++mt) {
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

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
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

template <int BM, int BITS, int QB>
void launch(const void* x, const void* packed, const void* meta, void* y,
            int M, int N, int KB, const MatFmt& mf, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  nxfp_matmul_kernel<BM, BITS, QB><<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const uint8_t*>(packed),
      reinterpret_cast<const uint16_t*>(meta), reinterpret_cast<float*>(y), M,
      N, KB, mf);
}

template <int BITS, int QB>
void launch_m(const void* x, const void* packed, const void* meta, void* y,
              int M, int N, int KB, const MatFmt& mf, cudaStream_t st) {
  if (M <= 16) launch<16, BITS, QB>(x, packed, meta, y, M, N, KB, mf, st);
  else launch<64, BITS, QB>(x, packed, meta, y, M, N, KB, mf, st);
}

}  // namespace

extern "C" int nxfp_matmul_launch(const void* x, const void* packed,
                                  const void* meta, void* y, int M, int N,
                                  int KB, int bits, int block_size,
                                  const void* fmt_desc, void* stream) {
  const MatFmt mf = *reinterpret_cast<const MatFmt*>(fmt_desc);
  if (M == 0 || N == 0) return 0;
  auto st = reinterpret_cast<cudaStream_t>(stream);
#define NXFP_MM(B, S) \
  if (bits == B && block_size == S) launch_m<B, S>(x, packed, meta, y, M, N, KB, mf, st); else
  NXFP_MM(4, 32) NXFP_MM(5, 32) NXFP_MM(6, 32) NXFP_MM(8, 32)
  NXFP_MM(4, 16) NXFP_MM(5, 16) NXFP_MM(6, 16) NXFP_MM(8, 16)
  return (int)cudaErrorInvalidValue;
#undef NXFP_MM
  return (int)cudaGetLastError();
}
