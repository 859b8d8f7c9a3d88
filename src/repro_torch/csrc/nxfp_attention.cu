// Flash-decode attention over an NxFP-packed KV cache.
//
// Replaces: src/repro/kernels/nxfp_attention.py:nxfp_decode_attention_pallas
// (bodies _kernel and _dequant_tile).
//
// One query token per sequence attends to its cached K/V rows:
//   q        (B, KVH, G, D) f32, already scaled by 1/sqrt(head_dim)
//   K/V      (B, S, KVH, NB, bpb) uint8 + (B, S, KVH, NB) uint16 meta
//            (uint32 for an asym format), blocks of 32 codes along
//            head_dim (D = NB * 32), decoded by nxfp_decode.cuh (ox and
//            asym formats included)
//   lengths  (B,) int32 valid rows per sequence
//   out      (B, KVH, G, D) f32
// As the TPU kernel: rows are dequantized to f32, both dots run in f32,
// the online softmax carries (m, l, acc) across S tiles, masked scores are
// -1e30, p = exp(s - m_new) is zeroed where masked, and the output is
// acc / max(l, 1e-30). Tiles wholly past a sequence's length are skipped,
// which is exact: they would contribute p = 0 and alpha = 1.
//
// Bound on the H100: the packed K/V bytes over the valid length (~4.5 bits
// per cached value). Design: one block of 128 threads per (batch, kv head)
// loops over S tiles of 32 rows. Each thread decodes one packed 32-value
// block of K and of V into shared memory; warp w scores query heads
// w, w+4, ... against the tile (lane = row), reduces max and sum with warp
// shuffles, and every thread then updates acc for its head_dim columns.
// B * KVH = 32 blocks underfill the 132 SMs at the Llama-3-8B smoke batch
// (B = 4, KVH = 8); splitting S across blocks (flash-decoding) with a
// second combine pass is later work.
#include <cuda_runtime.h>

#include "nxfp_decode.cuh"

namespace {

constexpr int kTS = 32;       // cache rows per tile (one per lane)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One packed block of QB codes -> f32 values at dst. A symmetric format
// takes one scale per block; the activation formats the per-element sign
// select and ox slot (nxfp_decode.cuh). The branch is uniform.
__device__ __forceinline__ void decode_row(const uint8_t* src, unsigned m,
                                           const float* lut,
                                           const nxfp::FmtDesc& af,
                                           float* dst) {
  const int QB = af.block_size, bits = af.bits;
  if (!af.asym && !af.ox) {
    int fb;
    const float sc = nxfp::decode_scale(m, &fb);
    for (int i = 0; i < QB; ++i)
      dst[i] = lut[fb * 256 + nxfp::unpack_code(src, i, bits)] * sc;
  } else {
    const nxfp::BlockScale s = nxfp::block_scale(m, af);
    for (int i = 0; i < QB; ++i) {
      const int c = nxfp::unpack_code(src, i, bits);
      dst[i] = nxfp::block_value(s, lut[s.fb * 256 + c], c, i, bits);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
nxfp_decode_attention_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ kp,
                             const void* __restrict__ km,
                             const uint8_t* __restrict__ vp,
                             const void* __restrict__ vm,
                             const int* __restrict__ lengths,
                             float* __restrict__ out, int S, int KVH, int G,
                             int NB, nxfp::FmtDesc af) {
  extern __shared__ float smem[];
  const int QB = af.block_size, bits = af.bits;
  const int bpb = QB * bits / 8;
  const int D = NB * QB, DP = D + 1;
  float* ks = smem;                   // [kTS][DP]
  float* vs = ks + kTS * DP;          // [kTS][DP]
  float* qs = vs + kTS * DP;          // [G][D]
  float* acc = qs + G * D;            // [G][D]
  float* ps = acc + G * D;            // [G][kTS]
  float* ms = ps + G * kTS;           // [G]
  float* ls = ms + G;                 // [G]
  float* al = ls + G;                 // [G]
  float* lut = al + G;                // [2][256]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);

  for (int i = tid; i < 512; i += kThreads) {
    const int code = i & 255;
    lut[i] = code < (1 << bits) ? nxfp::decode_elem(code, af.elem[i >> 8]) : 0.0f;
  }
  const float* qb = q + ((size_t)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = qb[i];
    acc[i] = 0.0f;
  }
  for (int i = tid; i < G; i += kThreads) {
    ms[i] = -1e30f;
    ls[i] = 0.0f;
  }

  for (int s0 = 0; s0 < len; s0 += kTS) {
    __syncthreads();  // previous tile consumed; init visible
    // dequantize the K and V tiles: one packed block per item
    for (int it = tid; it < kTS * NB; it += kThreads) {
      const int r = it / NB, j = it % NB, s = s0 + r;
      float* kd = ks + r * DP + j * QB;
      float* vd = vs + r * DP + j * QB;
      if (s < S) {
        const size_t blk = (((size_t)b * S + s) * KVH + h) * NB + j;
        decode_row(kp + blk * bpb, nxfp::read_meta(km, blk, af), lut,
                   af, kd);
        decode_row(vp + blk * bpb, nxfp::read_meta(vm, blk, af), lut,
                   af, vd);
      } else {
        for (int i = 0; i < QB; ++i) kd[i] = vd[i] = 0.0f;
      }
    }
    __syncthreads();
    // scores and the softmax carry: warp w takes heads w, w+kWarps, ...
    const bool valid = s0 + lane < len;
    for (int gg = warp; gg < G; gg += kWarps) {
      const float* qg = qs + gg * D;
      const float* kr = ks + lane * DP;
      float sc = 0.0f;
      for (int d = 0; d < D; ++d) sc += qg[d] * kr[d];
      sc = valid ? sc : -1e30f;
      const float m_old = ms[gg];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float alpha = expf(m_old - m_new);
      float p = expf(sc - m_new);
      p = valid ? p : 0.0f;
      ps[gg * kTS + lane] = p;
      const float psum = warp_sum(p);
      __syncwarp();
      if (lane == 0) {
        ls[gg] = ls[gg] * alpha + psum;
        ms[gg] = m_new;
        al[gg] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V over this tile; thread owns columns d
    for (int d = tid; d < D; d += kThreads) {
      for (int gg = 0; gg < G; ++gg) {
        float pv = 0.0f;
        for (int r = 0; r < kTS; ++r) pv += ps[gg * kTS + r] * vs[r * DP + d];
        acc[gg * D + d] = acc[gg * D + d] * al[gg] + pv;
      }
    }
  }
  __syncthreads();
  float* ob = out + ((size_t)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    ob[i] = acc[i] / fmaxf(ls[i / D], 1e-30f);
}

}  // namespace

extern "C" int nxfp_decode_attention_launch(
    const void* q, const void* kp, const void* km, const void* vp,
    const void* vm, const void* lengths, void* out, int B, int S, int KVH,
    int G, int NB, const void* fmt_desc, void* stream) {
  const nxfp::FmtDesc af = *reinterpret_cast<const nxfp::FmtDesc*>(fmt_desc);
  if (B == 0 || KVH == 0 || G == 0) return 0;
  const int D = NB * af.block_size;
  const size_t smem =
      sizeof(float) * ((size_t)2 * kTS * (D + 1) + 2 * G * D + G * kTS + 3 * G + 512);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nxfp_decode_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KVH, B);
  nxfp_decode_attention_kernel<<<grid, kThreads, smem,
                                 reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const uint8_t*>(kp),
      km, reinterpret_cast<const uint8_t*>(vp), vm,
      reinterpret_cast<const int*>(lengths), reinterpret_cast<float*>(out), S,
      KVH, G, NB, af);
  return (int)cudaGetLastError();
}
