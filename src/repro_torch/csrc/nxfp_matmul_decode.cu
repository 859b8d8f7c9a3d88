// Dequant GEMM, decode regime (M <= 16): y (M, N) f32 = bf16(x) (M, K) @
// bf16(dequant(Wq))^T.
//
// Replaces: src/repro/kernels/nxfp_matmul.py:nxfp_matmul_pallas (bodies
// _kernel and _decode_tile) for the few rows of a decode step.
//
// Bound on the H100: the packed weight bytes. At M 4 a Llama-3-8B MLP
// projection streams 33 MB of nxfp4 codes and scales (4.5 bits a weight)
// for 0.47 GFLOP: 0.0099 ms at 3.35 TB/s against 0.0005 ms of bf16
// tensor-core time. Decoding costs CUDA-core instructions per weight on
// top, so the kernel must keep bytes in flight on every SM and spend few
// instructions per weight.
//
// Design. Weight streaming with a deterministic split-K in one launch:
// - A CTA of eight warps owns a 64-column N tile, a warp 8 columns. Lane
//   (g, tq) reads block kb + tq of column g whole (16 bytes for nxfp4,
//   one vector load) with its meta word; the next step's block is loaded
//   while this one is decoded.
// - The product runs on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
//   M padded to 16 in registers only). The 16-deep K of one mma is taken
//   as 4 consecutive K values from each lane's own block: the sum over K
//   does not care which physical K each MMA slot holds, as long as x is
//   read in the same order. So a lane decodes its block's codes 4 at a
//   time straight into its B fragment (a shift, a LOP3, a LUT load per
//   code; a bf16 multiply by the block scale per pair), and x is staged
//   once per CTA in shared memory in that fragment order.
// - Split-K: grid (N tiles, splits), chosen on the host
//   (kernels/nxfp_matmul.py:decode_split) so every main-path shape fills
//   132 SMs. Each split writes its f32 partial tile to a scratch buffer;
//   the last CTA to arrive at a tile (an atomic counter per tile, reset
//   to 0 by that CTA) sums the partials in split order and writes y. No
//   atomics touch y, so the result is bitwise repeatable.
// - Formats: 4/5/6/8-bit codes at bs 16/32 read whole blocks (QB = bs).
//   Every other width and block size (3-bit codes, bs 8, 64, 128) runs the
//   generic instance of its width (GEN): a row of K codes is one long
//   block (nxfp_decode.cuh), read in units of 32 codes exactly as a bs-32
//   block, and each unit reads the meta word of every 8 codes it holds,
//   word n * KBm + (k >> lbs). The caller pads K to a multiple of 32.
// - The grouped instance (nxfp_matmul_grouped_launch) runs the routed
//   experts' rows of an MoE layer through the same split loop: one launch
//   for all experts, CTAs of an expert with no rows return at once, so a
//   decode step reads only the routed experts' weights. It replaces the
//   reference's XLA expert product (src/repro/models/moe.py:_expert_mm),
//   which dequantizes every expert and multiplies the whole (E, C, K)
//   dispatch buffer. Bound: the routed experts' packed bytes.
// How far it got (PERF.md, PR 14): at M 4 faster than torch.matmul bf16
// at every main-path shape, but ~0.035 ms on the MLP shapes, about a
// quarter of the bytes bound; at M 16 slower than torch.matmul.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nxfp_matmul.cuh"

namespace {

// The kernel's geometry. nxfp_matmul_decode_geometry hands it to the
// host's split planner (kernels/nxfp_matmul.py: decode_split).
constexpr int kThreads = 256;             // eight warps
constexpr int kBN = kThreads / 32 * 8;    // 64 columns per CTA
constexpr int kMaxM = 16;                 // x rows: one m16n8k16 A fragment
// The most x bytes a CTA stages: the split plan caps a chunk for kMaxM
// rows at every M, so that a row's sums do not depend on M (64 blocks of
// 32 at 16 rows, above every main-path chunk at M 4); past the 48 KB a
// launch gets unasked, so launch() raises the function's limit.
constexpr int kXSliceBytes = 65536;

__device__ __forceinline__ void mma_m16n8k16(float* d, const unsigned* a,
                                             const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A lane's block (GEN: its unit of 32 codes, with the meta word of each
// of its four octets).
template <int BITS, int QB, bool GEN>
struct Block {
  nxfp::PackedBlock<BITS, QB> pb;
  unsigned meta[GEN ? 4 : 1];
};

// x (M, K) bf16 -> xs in fragment order: entry ((ss * QB/4 + s) * 4 + t) * M
// + m holds x[m, k .. k + 3] for k = (kb0 + 4 ss + t) * QB + 4 s, the K
// values lane t's block feeds to MMA slot s in step ss. With `rows`, xs row
// m is x row rows[m] (the grouped instance's routed rows).
template <int QB>
__device__ __forceinline__ void stage_x(uint2* xs, const __nv_bfloat16* x,
                                        const int* rows, int M, int K,
                                        int k0, int ck, int tid) {
  const int quads = ck / 4;
  for (int c = tid; c < M * quads; c += kThreads) {
    const int m = c / quads, kl = 4 * (c % quads);
    const int ss = kl / (4 * QB), r = kl % (4 * QB);
    const int t = r / QB, s = r % QB / 4;
    const size_t xr = rows ? (size_t)rows[m] : (size_t)m;
    uint2 v = make_uint2(0u, 0u);
    if (k0 + kl < K)
      v = *reinterpret_cast<const uint2*>(x + xr * K + k0 + kl);
    xs[((ss * (QB / 4) + s) * 4 + t) * M + m] = v;
  }
}

// One CTA's split of the K loop over the M rows staged in xs: lane (g, tq)
// reads block kb0 + 4 ss + tq of weight column `col` (valid: inside the
// weight) and leaves in acc rows g and g + 8, columns 2 tq and 2 tq + 1 of
// its warp's 8. The first block's load overlaps the staging; the barrier
// after it makes xs and the LUT visible.
template <int BITS, int QB, bool EX, bool GEN>
__device__ __forceinline__ void split_mma(
    float* acc, const uint2* xs, const float* lut,
    const uint8_t* __restrict__ packed, const void* __restrict__ meta,
    size_t col, bool valid, int M, int KB, int kb0, int kb1, int KBm,
    int lbs, const nxfp::FmtDesc& fd, int g, int tq) {
  auto load = [&](int ss, Block<BITS, QB, GEN>& b) {
    const int kb = kb0 + 4 * ss + tq;
    if (valid && kb < kb1) {
      const size_t blk = col * KB + kb;
      nxfp::load_block_vec<BITS, QB>(b.pb, packed, blk);
      if constexpr (GEN) {
#pragma unroll
        for (int o = 0; o < 4; ++o)
          b.meta[o] = nxfp::read_meta(
              meta, col * KBm + ((kb * QB + 8 * o) >> lbs), fd);
      } else {
        b.meta[0] = nxfp::read_meta(meta, blk, fd);
      }
    } else {  // zero codes under a zero meta word decode to 0
#pragma unroll
      for (int j = 0; j < (QB * BITS + 31) / 32; ++j) b.pb.w[j] = 0u;
#pragma unroll
      for (int o = 0; o < (GEN ? 4 : 1); ++o) b.meta[o] = 0u;
    }
  };

  const int n_ss = (kb1 - kb0 + 3) / 4;
  const int bmask = (1 << lbs) - 1;
  Block<BITS, QB, GEN> cur;
  load(0, cur);
  __syncthreads();  // xs and the LUT written
  for (int ss = 0; ss < n_ss; ++ss) {
    Block<BITS, QB, GEN> nxt;
    if (ss + 1 < n_ss) load(ss + 1, nxt);
    nxfp::WScale<BITS, EX> sc;
    sc.set(cur.meta[0], fd);
#pragma unroll
    for (int s = 0; s < QB / 4; ++s) {
      // GEN: a new block every 8 codes at bs 8, every 16 at bs 16
      if constexpr (GEN) {
        if (s > 0 && (s & 1) == 0 && lbs < 5) sc.set(cur.meta[s >> 1], fd);
      }
      // the position within its block (read by the ox decode)
      const int pi = GEN ? ((4 * s) & bmask) : 4 * s;
      const uint2* xf = xs + ((ss * (QB / 4) + s) * 4 + tq) * M;
      const uint2 lo = g < M ? xf[g] : make_uint2(0u, 0u);
      const uint2 hi = g + 8 < M ? xf[g + 8] : make_uint2(0u, 0u);
      const unsigned a[4] = {lo.x, hi.x, lo.y, hi.y};
      const unsigned b[2] = {
          sc.pair(lut, nxfp::code_off(cur.pb, 4 * s),
                  nxfp::code_off(cur.pb, 4 * s + 1), pi),
          sc.pair(lut, nxfp::code_off(cur.pb, 4 * s + 2),
                  nxfp::code_off(cur.pb, 4 * s + 3), pi + 2)};
      mma_m16n8k16(acc, a, b);
    }
    cur = nxt;
  }
}

// KB: blocks per row (GEN: units of 32 codes); KBm, lbs: meta words per
// row and log2 of the block size (read by GEN only).
template <int BITS, int QB, bool EX, bool GEN>
__global__ void __launch_bounds__(kThreads)
nxfp_matmul_decode_kernel(const __nv_bfloat16* __restrict__ x,
                          const uint8_t* __restrict__ packed,
                          const void* __restrict__ meta,
                          float* __restrict__ y, float* __restrict__ ws,
                          int* __restrict__ counters, int M, int N, int KB,
                          int chunk, int KBm, int lbs, nxfp::FmtDesc fd) {
  extern __shared__ uint2 xs[];
  __shared__ float lut[2 << BITS];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int kb0 = split * chunk, kb1 = min(KB, kb0 + chunk);
  const int K = KB * QB;
  nxfp::fill_lut<BITS>(lut, fd, tid, kThreads);
  stage_x<QB>(xs, x, nullptr, M, K, kb0 * QB, chunk * QB, tid);

  const int n = tile * kBN + warp * 8 + g;  // this lane's column
  float acc[4] = {};
  split_mma<BITS, QB, EX, GEN>(acc, xs, lut, packed, meta, (size_t)n, n < N,
                               M, KB, kb0, kb1, KBm, lbs, fd, g, tq);

  // acc: rows g and g + 8, columns 2 tq and 2 tq + 1 of the warp's 8
  float* out = splits == 1 ? y : ws + (size_t)split * M * N;
  const int nc = tile * kBN + warp * 8 + 2 * tq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = g + 8 * h;
    if (m >= M) continue;
    if (nc < N) out[(size_t)m * N + nc] = acc[2 * h];
    if (nc + 1 < N) out[(size_t)m * N + nc + 1] = acc[2 * h + 1];
  }
  if (splits == 1) return;

  // the last split to finish this tile sums the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = tid; e < M * kBN; e += kThreads) {
    const int m = e / kBN, ne = tile * kBN + e % kBN;
    if (ne >= N) continue;
    float sum = 0.0f;
    for (int p = 0; p < splits; ++p)
      sum += __ldcg(ws + ((size_t)p * M + m) * N + ne);
    y[(size_t)m * N + ne] = sum;
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

template <int BITS, int QB, bool EX, bool GEN>
int launch(const void* x, const void* packed, const void* meta, void* y,
           int M, int N, int KB, int splits, int chunk, void* ws,
           void* counters, int KBm, int lbs, const nxfp::FmtDesc& fd,
           cudaStream_t st) {
  auto kernel = nxfp_matmul_decode_kernel<BITS, QB, EX, GEN>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSliceBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, splits);
  const size_t smem = (size_t)M * chunk * QB * sizeof(__nv_bfloat16);
  kernel<<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const uint8_t*>(packed), meta,
      reinterpret_cast<float*>(y), reinterpret_cast<float*>(ws),
      reinterpret_cast<int*>(counters), M, N, KB, chunk, KBm, lbs, fd);
  return (int)cudaGetLastError();
}

template <int BITS, int QB, bool GEN>
int launch_ex(const void* x, const void* packed, const void* meta, void* y,
              int M, int N, int KB, int splits, int chunk, void* ws,
              void* counters, int KBm, int lbs, const nxfp::FmtDesc& fd,
              cudaStream_t st) {
  // the weights are symmetric: their instance carries no activation-format
  // decode
  return (fd.asym || fd.ox)
             ? launch<BITS, QB, true, GEN>(x, packed, meta, y, M, N, KB,
                                           splits, chunk, ws, counters, KBm,
                                           lbs, fd, st)
             : launch<BITS, QB, false, GEN>(x, packed, meta, y, M, N, KB,
                                            splits, chunk, ws, counters, KBm,
                                            lbs, fd, st);
}

// The grouped instance (routed experts): y (R, N) f32, row r = bf16(x[r])
// @ bf16(dequant(W[expert[r]]))^T, 0 where expert[r] < 0. Grid (N tiles,
// splits, E): CTA (tile, split, e) scans `expert` for expert e's rows in
// order, gathers them into groups of at most kMaxM and runs each group
// through split_mma exactly as the 2D kernel runs its M rows, with the 2D
// kernel's split plan for this (K, N). A row's f32 partials and their sum
// in split order are therefore what the 2D kernel gives that row at any
// M <= 16 (the row's MMA slot does not change its sums). An expert
// with no rows reads no weight byte and touches no counter. The CTAs of
// expert 0, split 0, write the zero rows. Scratch: ws (splits, R, N) f32,
// counters one int per (expert, N tile), left at 0.
template <int BITS, int QB, bool GEN>
__global__ void __launch_bounds__(kThreads)
nxfp_matmul_grouped_kernel(const __nv_bfloat16* __restrict__ x,
                           const int* __restrict__ expert,
                           const uint8_t* __restrict__ packed,
                           const void* __restrict__ meta,
                           float* __restrict__ y, float* __restrict__ ws,
                           int* __restrict__ counters,
                           int R, int N, int KB, int chunk, int KBm, int lbs,
                           nxfp::FmtDesc fd) {
  extern __shared__ uint2 xs[];
  __shared__ float lut[2 << BITS];
  __shared__ int rows[kMaxM + kThreads];  // the expert's rows not yet run
  __shared__ int warp_hits[kThreads / 32];
  __shared__ int n_rows, n_seen, is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int e = blockIdx.z;
  const int kb0 = split * chunk, kb1 = min(KB, kb0 + chunk);
  const int K = KB * QB;
  const int n = tile * kBN + warp * 8 + g;      // this lane's weight column
  const int nc = tile * kBN + warp * 8 + 2 * tq;  // its accumulator columns

  if (e == 0 && split == 0) {
    for (int i = tid; i < R * kBN; i += kThreads) {
      const int r = i / kBN, ne = tile * kBN + i % kBN;
      if (ne < N && expert[r] < 0) y[(size_t)r * N + ne] = 0.0f;
    }
  }
  nxfp::fill_lut<BITS>(lut, fd, tid, kThreads);
  if (tid == 0) n_rows = n_seen = 0;
  __syncthreads();

  // rows[0, m) through this CTA's split; the caller's n_rows is uniform
  auto run = [&](int m) {
    stage_x<QB>(xs, x, rows, m, K, kb0 * QB, chunk * QB, tid);
    float acc[4] = {};
    split_mma<BITS, QB, false, GEN>(acc, xs, lut, packed, meta,
                                    (size_t)e * N + n, n < N, m, KB, kb0,
                                    kb1, KBm, lbs, fd, g, tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (g + 8 * h >= m) continue;
      const size_t r = rows[g + 8 * h];
      float* out = (splits == 1 ? y : ws + (size_t)split * R * N) + r * N;
      if (nc < N) out[nc] = acc[2 * h];
      if (nc + 1 < N) out[nc + 1] = acc[2 * h + 1];
    }
    __syncthreads();  // every warp is done with xs and rows[0, m)
  };

  for (int base = 0; base < R; base += kThreads) {
    // append this stretch's rows of expert e to rows[], in row order
    const int r = base + tid;
    const bool hit = r < R && expert[r] == e;
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ball);
    __syncthreads();
    int off = n_rows, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      off += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) rows[off + __popc(ball & ((1u << lane) - 1u))] = r;
    __syncthreads();
    if (tid == 0) {
      n_rows += total;
      n_seen += total;
    }
    __syncthreads();
    while (n_rows >= kMaxM) {
      run(kMaxM);
      const int rest = n_rows - kMaxM;
      const int v = tid < rest ? rows[kMaxM + tid] : 0;
      __syncthreads();
      if (tid < rest) rows[tid] = v;
      if (tid == 0) n_rows = rest;
      __syncthreads();
    }
  }
  if (n_rows > 0) run(n_rows);
  if (n_seen == 0 || splits == 1) return;

  // the last split to finish this (expert, tile) sums its rows' partials
  // in split order
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)e * gridDim.x + tile;
  if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < R * kBN; i += kThreads) {
    const int r = i / kBN, ne = tile * kBN + i % kBN;
    if (ne >= N || expert[r] != e) continue;
    float sum = 0.0f;
    for (int p = 0; p < splits; ++p)
      sum += __ldcg(ws + ((size_t)p * R + r) * N + ne);
    y[(size_t)r * N + ne] = sum;
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <int BITS, int QB, bool GEN>
int launch_grouped(const void* x, const void* expert, const void* packed,
                   const void* meta, void* y, int R, int N, int KB, int E,
                   int splits, int chunk, void* ws, void* counters, int KBm,
                   int lbs, const nxfp::FmtDesc& fd, cudaStream_t st) {
  auto kernel = nxfp_matmul_grouped_kernel<BITS, QB, GEN>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSliceBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, splits, E);
  const size_t smem = (size_t)kMaxM * chunk * QB * sizeof(__nv_bfloat16);
  kernel<<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const int*>(expert),
      reinterpret_cast<const uint8_t*>(packed), meta,
      reinterpret_cast<float*>(y), reinterpret_cast<float*>(ws),
      reinterpret_cast<int*>(counters), R, N, KB, chunk, KBm, lbs, fd);
  return (int)cudaGetLastError();
}

}  // namespace

int nxfp_matmul_decode(const void* x, const void* packed, const void* meta,
                       void* y, int M, int N, int KB, int splits, int chunk,
                       void* ws, void* counters, const nxfp::FmtDesc& fd,
                       cudaStream_t st) {
  // generic formats run in units of 32 codes: KU of them per row
  const int bs = fd.block_size, lbs = nxfp::log2_bs(bs);
  const bool gen = !nxfp::native_fmt(fd.bits, bs);
  if (gen && (!nxfp::generic_fmt(fd.bits, bs) || (long long)KB * bs % 32))
    return (int)cudaErrorInvalidValue;
  const int KU = gen ? (int)((long long)KB * bs / 32) : KB;
  const int qb = gen ? 32 : bs;
  // every split holds at least one K block and the splits cover KU once;
  // the x slice fits kXSliceBytes
  if (M < 1 || M > kMaxM || chunk < 4 || chunk % 4 != 0 || splits < 1 ||
      (long long)(splits - 1) * chunk >= KU ||
      (long long)splits * chunk < KU ||
      (size_t)M * chunk * qb * 2 > kXSliceBytes ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
#define NXFP_DEC(B, S)                                                       \
  if (fd.bits == B && bs == S)                                               \
    return launch_ex<B, S, false>(x, packed, meta, y, M, N, KB, splits,      \
                                  chunk, ws, counters, KB, lbs, fd, st);
  NXFP_DEC(4, 32) NXFP_DEC(5, 32) NXFP_DEC(6, 32) NXFP_DEC(8, 32)
  NXFP_DEC(4, 16) NXFP_DEC(5, 16) NXFP_DEC(6, 16) NXFP_DEC(8, 16)
#undef NXFP_DEC
#define NXFP_DEC_GEN(B)                                                      \
  if (fd.bits == B)                                                          \
    return launch_ex<B, 32, true>(x, packed, meta, y, M, N, KU, splits,      \
                                  chunk, ws, counters, KB, lbs, fd, st);
  NXFP_DEC_GEN(2) NXFP_DEC_GEN(3) NXFP_DEC_GEN(4) NXFP_DEC_GEN(5)
  NXFP_DEC_GEN(6) NXFP_DEC_GEN(7) NXFP_DEC_GEN(8)
#undef NXFP_DEC_GEN
  return (int)cudaErrorInvalidValue;
}

extern "C" int nxfp_matmul_decode_geometry(int* max_m, int* tile_n,
                                           int* x_slice_bytes) {
  *max_m = kMaxM;
  *tile_n = kBN;
  *x_slice_bytes = kXSliceBytes;
  return 0;
}

// The grouped instance: x (R, K) bf16 routed rows, expert (R,) int32 in
// [-1, E), W packed (E, N, KB, bpb) with meta (E, N, KB) uint16, y (R, N)
// f32. The split plan (splits, chunk) is the 2D decode regime's for
// (K, N) at kMaxM rows; with splits > 1, ws holds splits * R * N f32 and
// counters E * ceil(N / tile_n) ints, all 0. Symmetric (weight) formats
// only. Returns a cudaError_t.
extern "C" int nxfp_matmul_grouped_launch(
    const void* x, const void* expert, const void* packed, const void* meta,
    void* y, int R, int N, int KB, int E, const void* fmt_desc, int splits,
    int chunk, void* ws, void* counters, void* stream) {
  const nxfp::FmtDesc fd = *reinterpret_cast<const nxfp::FmtDesc*>(fmt_desc);
  if (R == 0 || N == 0) return 0;
  auto st = reinterpret_cast<cudaStream_t>(stream);
  const int bs = fd.block_size, lbs = nxfp::log2_bs(bs);
  const bool gen = !nxfp::native_fmt(fd.bits, bs);
  if (fd.asym || fd.ox || E < 1 ||
      (gen && (!nxfp::generic_fmt(fd.bits, bs) || (long long)KB * bs % 32)))
    return (int)cudaErrorInvalidValue;
  const int KU = gen ? (int)((long long)KB * bs / 32) : KB;
  const int qb = gen ? 32 : bs;
  if (chunk < 4 || chunk % 4 != 0 || splits < 1 ||
      (long long)(splits - 1) * chunk >= KU ||
      (long long)splits * chunk < KU ||
      (size_t)kMaxM * chunk * qb * 2 > kXSliceBytes ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
#define NXFP_GRP(B, S)                                                       \
  if (fd.bits == B && bs == S)                                               \
    return launch_grouped<B, S, false>(x, expert, packed, meta, y, R, N, KB, \
                                       E, splits, chunk, ws, counters, KB,   \
                                       lbs, fd, st);
  NXFP_GRP(4, 32) NXFP_GRP(5, 32) NXFP_GRP(6, 32) NXFP_GRP(8, 32)
  NXFP_GRP(4, 16) NXFP_GRP(5, 16) NXFP_GRP(6, 16) NXFP_GRP(8, 16)
#undef NXFP_GRP
#define NXFP_GRP_GEN(B)                                                      \
  if (fd.bits == B)                                                          \
    return launch_grouped<B, 32, true>(x, expert, packed, meta, y, R, N, KU, \
                                       E, splits, chunk, ws, counters, KB,   \
                                       lbs, fd, st);
  NXFP_GRP_GEN(2) NXFP_GRP_GEN(3) NXFP_GRP_GEN(4) NXFP_GRP_GEN(5)
  NXFP_GRP_GEN(6) NXFP_GRP_GEN(7) NXFP_GRP_GEN(8)
#undef NXFP_GRP_GEN
  return (int)cudaErrorInvalidValue;
}
