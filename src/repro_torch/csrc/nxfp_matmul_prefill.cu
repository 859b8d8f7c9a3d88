// Dequant GEMM, prefill regime (M > 16): y (M, N) f32 = bf16(x) (M, K) @
// bf16(dequant(Wq))^T.
//
// Replaces: src/repro/kernels/nxfp_matmul.py:nxfp_matmul_pallas (bodies
// _kernel and _decode_tile) for the many rows of a prefill.
//
// Bound on the H100: the bf16 tensor-core operations, 2*M*N*K (0.0608 ms
// at M 512 for a Llama-3-8B MLP projection, against 0.019 ms of bytes).
// Decoding W costs CUDA-core instructions on top, once per 128-row M tile.
//
// Design. wgmma.mma_async (sm_90a) fed by an asynchronous copy ring:
// - The product is taken transposed, y^T = W . x^T: a CTA tile of 128 W
//   rows (two consumer warpgroups of 64, the wgmma M) by 128 x rows (the
//   wgmma N), accumulators in registers (64 f32 a thread). W is the
//   register A operand: each thread decodes its fragment's codes straight
//   from the packed bytes into bf16 pairs, so the decoded W tile never
//   makes a shared-memory round trip and needs no swizzled layout. x is
//   the shared-memory B operand, K-major, 128-byte swizzled.
// - A ring of 4 stages of 64 K values, each tracked by one mbarrier: the
//   x tile (16 KB) arrives by TMA (one thread, complete_tx), the packed W
//   bytes and meta words of the 128 rows by cp.async from every thread
//   (cp.async.mbarrier.arrive.noinc). Ragged M, N and K arrive as zeros.
// - Per step, the 4 wgmma m64n128k16 of step t are issued and committed,
//   the A fragments of step t + 1 are decoded while they run, then
//   wgmma.wait_group 0 and one __syncthreads release stage t for the copy
//   of step t + 4. No producer warp and no persistent tile scheduler.
// - Formats: 4/5/6/8-bit codes at bs 16/32 stage whole blocks with their
//   meta words. Every other width and block size (3-bit codes, bs 8, 64,
//   128) runs the generic instance of its width (GEN): a row is one long
//   block (nxfp_decode.cuh) staged in units of 32 codes as bs-32 blocks,
//   and each 8 codes read their meta word, n * KBm + (k >> lbs), from
//   device memory (L1/L2) when they are decoded. The caller pads K to a
//   multiple of 32.
// How far it got (PERF.md, PR 14): ~0.2 ms at M 512 on the MLP shapes,
// ~30% of the operations bound and ~2.2x torch.matmul bf16. The W decode
// (with the copy issue, well over the four instructions per weight of the
// decode regime), once per 128-row M tile, is the likeliest limit of a
// step; no profiler counters on the card confirm it.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nxfp_matmul.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBN = 128;       // W rows (output columns) per CTA
constexpr int kBM = 128;       // x rows per CTA (the wgmma N)
constexpr int kBK = 64;        // K per stage
constexpr int kStages = 4;
constexpr int kXBytes = kBM * kBK * 2;
constexpr int kWBytes = kBN * kBK;            // 8-bit codes at most
constexpr int kMRow = kBK / 16;   // meta words per W row and stage
constexpr int kMBytes = kBN * kMRow * 4;
constexpr int kStageBytes = kXBytes + kWBytes + kMBytes;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;  // 0: zero-fill, read nothing
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}

// 4-byte copy of which the first `bytes` (0, 2 or 4) are read, the rest
// zero-filled
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// TMA: the (64 K x 128 row) box of x at (k0, m0) into dst, 128-byte
// swizzled, completing on bar; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load_x(void* dst, const CUtensorMap* map,
                                           int k0, int m0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(m0),
      "r"(smem_addr(bar)) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle (layout type 1): 8-row groups 1024 bytes apart
// (SBO), the leading offset unused. A k16 slice j starts 32 * j bytes in.
__device__ __forceinline__ uint64_t x_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const unsigned (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Stage layout: x tile | packed W rows | meta words (uint32 each).
struct Stage {
  uint8_t* base;
  __device__ __forceinline__ uint8_t* x() const { return base; }
  __device__ __forceinline__ uint8_t* w() const { return base + kXBytes; }
  __device__ __forceinline__ unsigned* m() const {
    return reinterpret_cast<unsigned*>(base + kXBytes + kWBytes);
  }
};

// KB: blocks per row (GEN: units of 32 codes); KBm, lbs: meta words per
// row and log2 of the block size (read by GEN only).
template <int BITS, int QB, bool EX, bool GEN>
__global__ void __launch_bounds__(kThreads, 1)
nxfp_matmul_prefill_kernel(const uint8_t* __restrict__ packed,
                           const void* __restrict__ meta,
                           float* __restrict__ y, int M, int N, int KB,
                           int KBm, int lbs, nxfp::FmtDesc fd,
                           const __grid_constant__ CUtensorMap xmap) {
  constexpr int kBpb = QB * BITS / 8;
  constexpr int kNB = kBK / QB;            // blocks per row per stage
  constexpr int kRow = kNB * kBpb;         // packed bytes per row per stage
  constexpr int kCW = kBpb % 16 == 0 ? 16 : (kBpb % 4 == 0 ? 4 : 2);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ float lut[2 << BITS];
  __shared__ __align__(8) uint64_t full[kStages];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int K = KB * QB;
  const int T = (K + kBK - 1) / kBK;
  const bool asym = fd.asym;  // uint32 meta words, else uint16
  const size_t n_meta = (size_t)N * KB;
  // the swizzle pattern repeats every 1024 bytes: align the stages to it
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  auto stage = [&](int s) { return Stage{smem + s * kStageBytes}; };
  // meta entry of block kb0 + b of stage row r, whose uint16 entries
  // start at index par (0 or 1) of its words; zero past K, as the ox decode
  // reads the E byte of a padding block
  auto stage_meta = [&](const Stage& sg, int r, int b, int kb0,
                        int par) -> unsigned {
    if (kb0 + b >= KB) return 0u;
    const unsigned* row = sg.m() + r * kMRow;
    if (asym) return row[b];
    return reinterpret_cast<const uint16_t*>(row)[par + b];
  };

  if (tid == 0) {
    // every thread's cp.async arrival, and thread 0's expect_tx for x
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kThreads + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  nxfp::fill_lut<BITS>(lut, fd, tid, kThreads);
  __syncthreads();

  // copies of step t into its stage: the x tile by TMA, the packed W bytes
  // and meta words by cp.async. Thread pair (2r, 2r + 1) copies row r;
  // the addresses move by a fixed stride per step, so they are set up once.
  constexpr int kItems = kRow / kCW / 2;  // W copies per thread and step
  const int cr = tid >> 1, half = tid & 1;
  const bool row_ok = n0 + cr < N;
  const uint8_t* w_src = packed + (size_t)(row_ok ? n0 + cr : 0) * KB * kBpb;
  const int m_words = asym ? kNB : kNB / 2 + 1;  // meta words per row
  const int m_step = asym ? kNB : kNB / 2;       // their stride per step
  const size_t m_base = ((size_t)(n0 + cr) * KB) >> (asym ? 0 : 1);
  const size_t m_valid = asym ? n_meta : (n_meta + 1) / 2;
  auto issue = [&](int t) {
    const Stage sg = stage(t % kStages);
    if (tid == 0) {
      mbar_expect_tx(&full[t % kStages], kXBytes);
      tma_load_x(sg.x(), &xmap, t * kBK, m0, &full[t % kStages]);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int off = (half * kItems + i) * kCW;
      const bool ok = row_ok && t * kNB + off / kBpb < KB;
      const uint8_t* src = ok ? w_src + t * kRow + off : packed;
      uint8_t* dst = sg.w() + cr * kRow + off;
      if constexpr (kCW == 2)  // 10-byte blocks: no cp.async width fits
        *reinterpret_cast<uint16_t*>(dst) =
            ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
      else
        cp_async<kCW>(dst, src, ok);
    }
    // meta: the aligned 4-byte words covering row cr's kNB entries
    // (uint16 entries may start at an odd index, see par); GEN reads its
    // meta words from device memory instead
    for (int i = half; i < (GEN ? 0 : m_words); i += 2) {
      const size_t wd = m_base + (size_t)t * m_step + i;
      int bytes = 0;
      if (row_ok && wd < m_valid)
        bytes = (!asym && 2 * wd + 1 >= n_meta) ? 2 : 4;
      cp_async_n(sg.m() + cr * kMRow + i,
                 reinterpret_cast<const unsigned*>(meta) + (bytes ? wd : 0),
                 bytes);
    }
    mbar_cp_async_arrive(&full[t % kStages]);
  };
  for (int t = 0; t < kStages && t < T; ++t) issue(t);
  if constexpr (kCW == 2) __syncthreads();  // plain stores of the W bytes

  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ra = wg * 64 + w * 16 + g;  // this thread's A rows: ra, ra + 8
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  int par[2];  // where this thread's rows' uint16 meta entries start
#pragma unroll
  for (int h = 0; h < 2; ++h)
    par[h] = (int)(((size_t)(n0 + ra + 8 * h) * KB) & 1);

  // A fragments of step t: rows ra / ra + 8, K 2tq..2tq+1 and 2tq+8..2tq+9
  // of each k16 slice. One scale per (row, block); 4-bit codes come four
  // words at a time (byte tq of each holds this thread's code pairs).
  using Frag = unsigned[kBK / 16][4];
  const int bmask = (1 << lbs) - 1;
  // GEN: the meta word of the 8 codes at row position k of W row n (0 past
  // K, as the ox decode reads the E byte of a padding block)
  auto gmeta = [&](int n, int k) -> unsigned {
    return (n < N && k < K)
               ? nxfp::read_meta(meta, (size_t)n * KBm + (k >> lbs), fd)
               : 0u;
  };
  auto decode = [&](int t, Frag& a) {
    const Stage sg = stage(t % kStages);
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
        nxfp::WScale<BITS, EX> sc;
        if constexpr (!GEN) sc.set(stage_meta(sg, r, b, t * kNB, par[h]), fd);
        const uint8_t* blk = sg.w() + r * kRow + b * kBpb;
#pragma unroll
        for (int q = 0; q < QB / 16; ++q) {  // the block's k16 slices
          const int j = b * (QB / 16) + q, o = 16 * q + 2 * tq;
          unsigned o0, o1, o2, o3;  // LUT offsets of codes o, o+1, o+8, o+9
          if constexpr (BITS == 4) {
            // byte tq of each word: codes o, o+1 (low word), o+8, o+9
            const uint2 v = reinterpret_cast<const uint2*>(blk)[q];
            o0 = (v.x << 2) >> (8 * tq);
            o1 = v.x >> (8 * tq + 2);
            o2 = (v.y << 2) >> (8 * tq);
            o3 = v.y >> (8 * tq + 2);
          } else {
            constexpr unsigned kMask = (1u << BITS) - 1u;
            const unsigned p0 = nxfp::smem_code_pair<BITS>(blk, o);
            const unsigned p1 = nxfp::smem_code_pair<BITS>(blk, o + 8);
            o0 = (p0 & kMask) << 2;
            o1 = (p0 >> BITS) << 2;
            o2 = (p1 & kMask) << 2;
            o3 = (p1 >> BITS) << 2;
          }
          if constexpr (GEN) {
            // codes o, o + 1 and o + 8, o + 9 lie in octets 2q and 2q + 1
            const int k0 = t * kBK + b * QB + 16 * q;
            nxfp::WScale<BITS, EX> hi;
            sc.set(gmeta(n0 + r, k0), fd);
            hi.set(gmeta(n0 + r, k0 + 8), fd);
            a[j][h] = sc.pair(lut, o0, o1, o & bmask);
            a[j][2 + h] = hi.pair(lut, o2, o3, (o + 8) & bmask);
          } else {
            a[j][h] = sc.pair(lut, o0, o1, o);
            a[j][2 + h] = sc.pair(lut, o2, o3, o + 8);
          }
        }
      }
    }
  };
  // step t: its wgmmas run on `cur` while the next step's fragments are
  // decoded into `nxt`; then stage t is free for step t + kStages
  auto step = [&](int t, Frag& cur, Frag& nxt) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const unsigned xa = smem_addr(stage(t % kStages).x());
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      wgmma_m64n128k16(d, cur[j], x_desc(xa + 32 * j));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (t + 1 < T) decode(t + 1, nxt);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
    __syncthreads();  // stage t read by its wgmmas and decoded one step ago
    if (t + kStages < T) issue(t + kStages);
  };
  Frag fa, fb;
  decode(0, fa);
  for (int t = 0; t < T; t += 2) {
    step(t, fa, fb);
    if (t + 1 < T) step(t + 1, fb, fa);
  }

  // d[4j + 2h + e]: W row ra + 8h (output column), x row 8j + 2tq + e
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + ra + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tq + e;
        if (m < M && n < N) y[(size_t)m * N + n] = d[4 * j + 2 * h + e];
      }
    }
}

// The TMA map of x (M, K) bf16, row-major: boxes of 64 K x 128 rows,
// 128-byte swizzled. cuTensorMapEncodeTiled comes from the driver through
// the runtime, so the library links no libcuda.
int x_tensor_map(CUtensorMap* map, const void* x, int M, int K) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BITS, int QB, bool EX, bool GEN>
int launch(const void* x, const void* packed, const void* meta, void* y,
           int M, int N, int KB, int KBm, int lbs, const nxfp::FmtDesc& fd,
           cudaStream_t st) {
  auto kernel = nxfp_matmul_prefill_kernel<BITS, QB, EX, GEN>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  // M tiles fastest: the CTAs that share a W tile run together
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  CUtensorMap xmap;
  const int rc = x_tensor_map(&xmap, x, M, KB * QB);
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, kSmem, st>>>(
      reinterpret_cast<const uint8_t*>(packed), meta,
      reinterpret_cast<float*>(y), M, N, KB, KBm, lbs, fd, xmap);
  return (int)cudaGetLastError();
}

template <int BITS, int QB, bool GEN>
int launch_ex(const void* x, const void* packed, const void* meta, void* y,
              int M, int N, int KB, int KBm, int lbs,
              const nxfp::FmtDesc& fd, cudaStream_t st) {
  return (fd.asym || fd.ox)
             ? launch<BITS, QB, true, GEN>(x, packed, meta, y, M, N, KB, KBm,
                                           lbs, fd, st)
             : launch<BITS, QB, false, GEN>(x, packed, meta, y, M, N, KB,
                                            KBm, lbs, fd, st);
}

}  // namespace

int nxfp_matmul_prefill(const void* x, const void* packed, const void* meta,
                        void* y, int M, int N, int KB,
                        const nxfp::FmtDesc& fd, cudaStream_t st) {
  if ((N + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  const int bs = fd.block_size, lbs = nxfp::log2_bs(bs);
#define NXFP_PF(B, S) \
  if (fd.bits == B && bs == S) \
    return launch_ex<B, S, false>(x, packed, meta, y, M, N, KB, KB, lbs, fd, \
                                  st);
  NXFP_PF(4, 32) NXFP_PF(5, 32) NXFP_PF(6, 32) NXFP_PF(8, 32)
  NXFP_PF(4, 16) NXFP_PF(5, 16) NXFP_PF(6, 16) NXFP_PF(8, 16)
#undef NXFP_PF
  // generic formats run in units of 32 codes: KB * bs / 32 of them per row
  if (!nxfp::generic_fmt(fd.bits, bs) || (long long)KB * bs % 32)
    return (int)cudaErrorInvalidValue;
  const int KU = (int)((long long)KB * bs / 32);
#define NXFP_PF_GEN(B) \
  if (fd.bits == B) \
    return launch_ex<B, 32, true>(x, packed, meta, y, M, N, KU, KB, lbs, fd, \
                                  st);
  NXFP_PF_GEN(2) NXFP_PF_GEN(3) NXFP_PF_GEN(4) NXFP_PF_GEN(5)
  NXFP_PF_GEN(6) NXFP_PF_GEN(7) NXFP_PF_GEN(8)
#undef NXFP_PF_GEN
  return (int)cudaErrorInvalidValue;
}
