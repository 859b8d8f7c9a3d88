// Flash-decode attention over an NxFP-packed KV cache.
//
// Replaces: src/repro/kernels/nxfp_attention.py:nxfp_decode_attention_pallas
// (bodies _kernel and _dequant_tile).
//
// One query token per sequence attends to its cached K/V rows:
//   q        (B, KVH, G, D) f32, already scaled by 1/sqrt(head_dim)
//   K/V      (B, S, KVH, NB, bpb) uint8 + (B, S, KVH, NB) uint16 meta
//            (uint32 for an asym format), blocks of bs codes along
//            head_dim (D = NB * bs), decoded by nxfp_decode.cuh (ox and
//            asym formats included): 4/5/6/8-bit codes at bs 16/32 by
//            instances that read whole blocks, every other width and block
//            size (3-bit codes, bs 8, 64, 128) by a generic instance per
//            width that reads each row as one long block, 8 codes at a
//            time, and takes bs as a runtime shift
//   lengths  (B,) int32 valid rows per sequence
//   out      (B, KVH, G, D) f32
// As the TPU kernel: rows are dequantized to f32, both dots run in f32 on
// the CUDA cores, the online softmax carries (m, l, acc) across S tiles,
// masked scores are -1e30, p = exp(s - m_new) is zeroed where masked, and
// the output is acc / max(l, 1e-30).
//
// Bound on the H100: the packed K/V bytes over the valid length (~4.5 bits
// per cached value): at B 4, S 256 about 0.8 MB, 0.00025 ms at 3.35 TB/s,
// so a launch is set by latency, and by how many SMs share the work.
//
// Design: split-S (flash-decoding) in one launch.
// - Grid (KVH, B, splits): split s of a (b, kv head) takes the whole
//   32-row tiles [s * tps, (s + 1) * tps) of the cache. The host plans
//   splits and tps from the cache length S alone, never from lengths
//   (kernels/nxfp_attention.py: attention_split, about two CTAs per SM),
//   so nothing waits on the device.
// - Each CTA of 128 threads runs the online softmax over the rows of its
//   range below the sequence's length. Per tile, each thread decodes
//   packed blocks of K and V (codes read at compile-time widths, one
//   2 << BITS LUT) into shared memory; warp w scores query heads w, w + 4,
//   ... (lane = row) with warp-shuffle max and sum; every thread then
//   updates acc for its head_dim columns. A range wholly past the length
//   leaves m = -1e30, l = 0, acc = 0: exactly what its tiles would add.
// - With splits > 1 each CTA writes (acc, m, l) in f32 to a scratch
//   buffer; the last CTA of each (b, kv head) to finish (a counter it
//   resets to 0) merges them in split order: M = max m_i, l = sum l_i
//   e^(m_i - M), acc = sum acc_i e^(m_i - M). No atomics touch the output,
//   so a second launch gives the same bits. A length-0 sequence gives 0.
// Dense-row instance (QB = -1, entry nxfp_dense_attention_launch): the
// same kernel over a bf16 cache, K/V (B, S, KVH, D) as the dense cache
// lays them out, D any multiple of 8 (head_dim 120 included). Only the
// tile loader differs: 8 bf16 values a thread per 16-byte load, widened to
// f32 exactly. Scores, online softmax, split plan and split-order merge
// are the packed instance's, so a row's bits do not depend on B (the
// dense cache's einsum, a batched cuBLAS product, moved them with B). Its
// bound is the bf16 K/V bytes over the valid length.
// How far it got: PERF.md (the kernel table).
#include <cuda_runtime.h>

#include "nxfp_decode.cuh"

namespace {

constexpr int kTS = 32;       // cache rows per tile (one per lane)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One packed block of QB codes -> f32 values at dst (the reference's
// f32 dequant: element value times its sign's scale, or the ox value).
template <int BITS, int QB, bool EX>
__device__ __forceinline__ void decode_row(const uint8_t* __restrict__ packed,
                                           const void* __restrict__ meta,
                                           size_t blk, const float* lut,
                                           const nxfp::FmtDesc& af,
                                           float* dst) {
  nxfp::PackedBlock<BITS, QB> pb;
  nxfp::load_block_vec<BITS, QB>(pb, packed, blk);
  if (!EX) {
    int fb;
    const float sc = nxfp::decode_scale(
        reinterpret_cast<const uint16_t*>(meta)[blk], &fb);
    const float* lt = lut + (fb << BITS);
#pragma unroll
    for (int i = 0; i < QB; ++i) dst[i] = lt[pb.code(i)] * sc;
  } else {
    const nxfp::BlockScale s =
        nxfp::block_scale(nxfp::read_meta(meta, blk, af), af);
    const float* lt = lut + (s.fb << BITS);
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      const int c = pb.code(i);
      dst[i] = nxfp::block_value(s, lt[c], c, i, BITS);
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

// QB: the block size of an instance that reads whole blocks, 0 for the
// generic instance (bs = 1 << lbs, any power of two from 8 to 128), -1
// for bf16 rows (kp/vp the bf16 caches, NB = D, lbs = 0; km/vm unused).
template <int BITS, int QB, bool EX>
__global__ void __launch_bounds__(kThreads)
nxfp_decode_attention_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ kp,
                             const void* __restrict__ km,
                             const uint8_t* __restrict__ vp,
                             const void* __restrict__ vm,
                             const int* __restrict__ lengths,
                             float* __restrict__ out, float* __restrict__ ws,
                             int* __restrict__ counters, int S, int KVH,
                             int G, int NB, int tps, int lbs,
                             nxfp::FmtDesc af) {
  extern __shared__ float smem[];
  __shared__ float lut[2 << BITS];
  __shared__ int is_last;
  const int D = QB > 0 ? NB * QB : NB << lbs, DP = D + 1;
  float* ks = smem;                   // [kTS][DP]
  float* vs = ks + kTS * DP;          // [kTS][DP]
  float* qs = vs + kTS * DP;          // [G][D]
  float* acc = qs + G * D;            // [G][D]
  float* ps = acc + G * D;            // [G][kTS]
  float* ms = ps + G * kTS;           // [G]
  float* ls = ms + G;                 // [G]
  float* al = ls + G;                 // [G]

  const int h = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const int r0 = split * tps * kTS, r1 = min(len, r0 + tps * kTS);
  const size_t bh = (size_t)b * KVH + h;

  if constexpr (QB >= 0) nxfp::fill_lut<BITS>(lut, af, tid, kThreads);
  const float* qb = q + bh * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = qb[i];
    acc[i] = 0.0f;
  }
  for (int i = tid; i < G; i += kThreads) {
    ms[i] = -1e30f;
    ls[i] = 0.0f;
  }

  for (int s0 = r0; s0 < r1; s0 += kTS) {
    __syncthreads();  // previous tile consumed; init visible
    if constexpr (QB > 0) {
      // dequantize the K and V tiles: one packed block per item
      for (int it = tid; it < kTS * NB; it += kThreads) {
        const int r = it / NB, j = it % NB, s = s0 + r;
        float* kd = ks + r * DP + j * QB;
        float* vd = vs + r * DP + j * QB;
        if (s < S) {
          const size_t blk = (((size_t)b * S + s) * KVH + h) * NB + j;
          decode_row<BITS, QB, EX>(kp, km, blk, lut, af, kd);
          decode_row<BITS, QB, EX>(vp, vm, blk, lut, af, vd);
        } else {
#pragma unroll
          for (int i = 0; i < QB; ++i) kd[i] = vd[i] = 0.0f;
        }
      }
    } else if constexpr (QB < 0) {
      // bf16 rows: 8 values per item, one 16-byte load each (D % 8 == 0)
      const int no = D / 8;
      for (int it = tid; it < kTS * no; it += kThreads) {
        const int r = it / no, j = it % no, s = s0 + r;
        float* kd = ks + r * DP + 8 * j;
        float* vd = vs + r * DP + 8 * j;
        if (s < S) {
          const size_t at = ((((size_t)b * S + s) * KVH + h) * D + 8 * j) * 2;
          const uint4 kw = *reinterpret_cast<const uint4*>(kp + at);
          const uint4 vw = *reinterpret_cast<const uint4*>(vp + at);
          const uint32_t kx[4] = {kw.x, kw.y, kw.z, kw.w};
          const uint32_t vx[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kd[2 * i] = __uint_as_float(kx[i] << 16);
            kd[2 * i + 1] = __uint_as_float(kx[i] & 0xffff0000u);
            vd[2 * i] = __uint_as_float(vx[i] << 16);
            vd[2 * i + 1] = __uint_as_float(vx[i] & 0xffff0000u);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kd[i] = vd[i] = 0.0f;
        }
      }
    } else {
      // generic: a row of D codes is one long block, 8 codes per item
      const int no = D / 8;
      for (int it = tid; it < kTS * no; it += kThreads) {
        const int r = it / no, j = it % no, s = s0 + r;
        float* kd = ks + r * DP + 8 * j;
        float* vd = vs + r * DP + 8 * j;
        if (s < S) {
          const size_t row = ((size_t)b * S + s) * KVH + h;
          const size_t at = row * D / 8 * BITS + (size_t)j * BITS;
          const size_t mi = row * NB + ((8 * j) >> lbs);
          const int i0 = (8 * j) & ((1 << lbs) - 1);
          nxfp::decode_octet<BITS, EX>(nxfp::load_octet<BITS>(kp + at),
                                       nxfp::read_meta(km, mi, af), i0, lut,
                                       af, kd);
          nxfp::decode_octet<BITS, EX>(nxfp::load_octet<BITS>(vp + at),
                                       nxfp::read_meta(vm, mi, af), i0, lut,
                                       af, vd);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kd[i] = vd[i] = 0.0f;
        }
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
  float* ob = out + bh * G * D;
  if (splits == 1) {
    for (int i = tid; i < G * D; i += kThreads)
      ob[i] = acc[i] / fmaxf(ls[i / D], 1e-30f);
    return;
  }

  // this split's partial: acc [G][D], then m [G], then l [G]
  const int part = G * D + 2 * G;
  float* mine = ws + (bh * splits + split) * part;
  for (int i = tid; i < G * D; i += kThreads) mine[i] = acc[i];
  for (int i = tid; i < G; i += kThreads) {
    mine[G * D + i] = ms[i];
    mine[G * D + G + i] = ls[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[bh], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last split merges all of them in split order
  const float* parts = ws + bh * splits * part;
  for (int gg = tid; gg < G; gg += kThreads) {
    float mx = -1e30f;
    for (int p = 0; p < splits; ++p)
      mx = fmaxf(mx, __ldcg(parts + (size_t)p * part + G * D + gg));
    float l = 0.0f;
    for (int p = 0; p < splits; ++p) {
      const float* pp = parts + (size_t)p * part + G * D;
      l += __ldcg(pp + G + gg) * expf(__ldcg(pp + gg) - mx);
    }
    ms[gg] = mx;
    ls[gg] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int gg = i / D;
    float a = 0.0f;
    for (int p = 0; p < splits; ++p) {
      const float* pp = parts + (size_t)p * part;
      a += __ldcg(pp + i) * expf(__ldcg(pp + G * D + gg) - ms[gg]);
    }
    ob[i] = a / fmaxf(ls[gg], 1e-30f);
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *kp, *km, *vp, *vm, *lengths;
  void *out, *ws, *counters;
  int B, S, KVH, G, NB, splits, tps, lbs;
  nxfp::FmtDesc af;
  cudaStream_t st;
};

template <int BITS, int QB, bool EX>
int launch(const Args& a) {
  auto kernel = nxfp_decode_attention_kernel<BITS, QB, EX>;
  const int D = a.NB << a.lbs;
  const size_t smem =
      sizeof(float) * ((size_t)2 * kTS * (D + 1) + 2 * a.G * D + a.G * kTS + 3 * a.G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.KVH, a.B, a.splits);
  kernel<<<grid, kThreads, smem, a.st>>>(
      reinterpret_cast<const float*>(a.q),
      reinterpret_cast<const uint8_t*>(a.kp), a.km,
      reinterpret_cast<const uint8_t*>(a.vp), a.vm,
      reinterpret_cast<const int*>(a.lengths), reinterpret_cast<float*>(a.out),
      reinterpret_cast<float*>(a.ws), reinterpret_cast<int*>(a.counters), a.S,
      a.KVH, a.G, a.NB, a.tps, a.lbs, a.af);
  return (int)cudaGetLastError();
}

template <int BITS, int QB>
int launch_ex(const Args& a) {
  // a symmetric cache's instance carries no activation-format decode
  return (a.af.asym || a.af.ox) ? launch<BITS, QB, true>(a)
                                : launch<BITS, QB, false>(a);
}

}  // namespace

// splits x tps 32-row tiles cover the ceil(S / 32) tiles of the cache,
// every split holding one at least; with splits > 1, ws holds B * KVH *
// splits * (G * D + 2 * G) f32 and counters B * KVH ints, all 0.
extern "C" int nxfp_decode_attention_launch(
    const void* q, const void* kp, const void* km, const void* vp,
    const void* vm, const void* lengths, void* out, int B, int S, int KVH,
    int G, int NB, const void* fmt_desc, int splits, int tps, void* ws,
    void* counters, void* stream) {
  const auto af = *reinterpret_cast<const nxfp::FmtDesc*>(fmt_desc);
  const int bs = af.block_size, lbs = nxfp::log2_bs(bs);
  const Args a{q, kp, km, vp, vm, lengths, out, ws, counters, B, S, KVH, G,
               NB, splits, tps, lbs, af,
               reinterpret_cast<cudaStream_t>(stream)};
  if (B == 0 || KVH == 0 || G == 0) return 0;
  if (bs < 8 || bs > 128 || (1 << lbs) != bs) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)S + kTS - 1) / kTS;
  if (splits < 1 || tps < 1 || splits > 65535 || B > 65535 ||
      (long long)(splits - 1) * tps >= (tiles > 0 ? tiles : 1) ||
      (long long)splits * tps < tiles ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
#define NXFP_ATT(BI, QS) \
  if (a.af.bits == BI && a.af.block_size == QS) return launch_ex<BI, QS>(a);
  NXFP_ATT(4, 32) NXFP_ATT(5, 32) NXFP_ATT(6, 32) NXFP_ATT(8, 32)
  NXFP_ATT(4, 16) NXFP_ATT(5, 16) NXFP_ATT(6, 16) NXFP_ATT(8, 16)
#undef NXFP_ATT
  // every other width and block size: the generic instance of the width
#define NXFP_ATT_GEN(BI) if (a.af.bits == BI) return launch_ex<BI, 0>(a);
  NXFP_ATT_GEN(2) NXFP_ATT_GEN(3) NXFP_ATT_GEN(4) NXFP_ATT_GEN(5)
  NXFP_ATT_GEN(6) NXFP_ATT_GEN(7) NXFP_ATT_GEN(8)
#undef NXFP_ATT_GEN
  return (int)cudaErrorInvalidValue;
}

// The dense-row instance: K/V (B, S, KVH, D) bf16, 16-byte aligned, D a
// multiple of 8; the split plan and scratch as above.
extern "C" int nxfp_dense_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int KVH, int G, int D, int splits, int tps,
    void* ws, void* counters, void* stream) {
  const Args a{q, k, nullptr, v, nullptr, lengths, out, ws, counters, B, S,
               KVH, G, D, splits, tps, 0, nxfp::FmtDesc{},
               reinterpret_cast<cudaStream_t>(stream)};
  if (B == 0 || KVH == 0 || G == 0) return 0;
  const long long tiles = ((long long)S + kTS - 1) / kTS;
  if (D < 8 || D % 8 || splits < 1 || tps < 1 || splits > 65535 ||
      B > 65535 || (long long)(splits - 1) * tps >= (tiles > 0 ? tiles : 1) ||
      (long long)splits * tps < tiles ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch<4, -1, false>(a);
}
