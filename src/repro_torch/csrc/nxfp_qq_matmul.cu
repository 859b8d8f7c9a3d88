// Quantized x quantized GEMM: y (M, N) f32 = dequant(Xq) @ dequant(Wq)^T.
//
// Replaces: src/repro/kernels/nxfp_qq_matmul.py:nxfp_qq_matmul_pallas
// (bodies _kernel and _decode_tile).
//
// Both operands arrive packed along the contraction axis K, in blocks of
// one shared block size:
//   Xq  (M, KB, bpb_x) uint8 + (M, KB) meta: the prefill activation,
//       uint32 meta for an asym format (AMXFP), uint16 otherwise
//   Wq  (N, KB, bpb_w) uint8 + (N, KB) meta: the weight (axis-0 cast)
// As the TPU kernel, every packed block of both operands is decoded to f32
// (element value x its sign's block scale, or the ox outlier value; all
// exact) and rounded to bf16 with round-to-nearest-even, and the bf16
// operands are multiplied with f32 accumulation.
//
// Bound on the H100: at prefill (M = 512) the bf16 tensor-core operations,
// 2*M*N*K (0.0608 ms for a Llama-3-8B MLP projection); the packed bytes of
// both operands are ~(bits_x + bits_w)/32 of the bf16 product's.
//
// Design: X is decoded once, then the dequant GEMM runs on it unchanged.
// - Decode pass (this file): one thread per packed X block decodes it with
//   nxfp_decode.cuh's decode_block_bf16 (the rounding of _decode_tile) and
//   writes its QB bf16 values with 16-byte stores into a (M, K) bf16
//   buffer that the caller allocates. At M 512, K 14336 that buffer is
//   14.7 MB written and read back once, ~9 us at 3.35 TB/s.
// - Mainloop: the same call then runs nxfp_matmul_launch on that buffer,
//   the dequant GEMM's regime as its caller planned it: the split-K weight
//   streaming of nxfp_matmul_decode.cu when there is a split (M <= 16),
//   the wgmma pipeline of nxfp_matmul_prefill.cu otherwise.
// - Formats: 4/5/6/8-bit X codes at bs 16/32 decode a block per thread;
//   every other width and block size (3-bit codes, bs 8, 64, 128) runs the
//   generic decode of its width, 8 codes per thread, each reading the meta
//   word of its block at row position k, m * KB + (k >> lbs) (an X row is
//   one long block, nxfp_decode.cuh). The mainloop takes W's format as
//   nxfp_matmul_launch does.
// So the result is, bit for bit, nxfp_matmul of the decoded X: each X
// value is decoded once rather than once per W tile, and the X decode
// adds no work to the mainloop, whose W decode is its likeliest limit.
// How far it got: PERF.md (the kernel table).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nxfp_matmul.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// Block i of Xq -> xd[i * QB, (i + 1) * QB) bf16: xd is X (M, K) row-major,
// since block i of row m is block m * KB + kb.
template <int BITS, int QB, bool EX>
__global__ void __launch_bounds__(kThreads)
nxfp_qq_decode_x_kernel(const uint8_t* __restrict__ xp,
                        const void* __restrict__ xm,
                        __nv_bfloat16* __restrict__ xd, long long n_blocks,
                        nxfp::FmtDesc f) {
  __shared__ float lut[2 << BITS];
  nxfp::fill_lut<BITS>(lut, f, threadIdx.x, kThreads);
  __syncthreads();
  const long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= n_blocks) return;
  __nv_bfloat162 v[QB / 2];
  nxfp::decode_block_bf16<BITS, QB, EX>(xp, xm, (size_t)blk, lut, f, v);
  uint4* dst = reinterpret_cast<uint4*>(xd + blk * QB);
#pragma unroll
  for (int j = 0; j < QB / 8; ++j)
    dst[j] = make_uint4(bf2_bits(v[4 * j]), bf2_bits(v[4 * j + 1]),
                        bf2_bits(v[4 * j + 2]), bf2_bits(v[4 * j + 3]));
}

// Generic decode: octet o of Xq (codes 8o .. 8o + 7 of X in row-major
// order; rows hold KO octets) -> xd[8o, 8o + 8) bf16.
template <int BITS, bool EX>
__global__ void __launch_bounds__(kThreads)
nxfp_qq_decode_x_generic_kernel(const uint8_t* __restrict__ xp,
                                const void* __restrict__ xm,
                                __nv_bfloat16* __restrict__ xd,
                                long long n_oct, int KO, int KB, int lbs,
                                nxfp::FmtDesc f) {
  __shared__ float lut[2 << BITS];
  nxfp::fill_lut<BITS>(lut, f, threadIdx.x, kThreads);
  __syncthreads();
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= n_oct) return;
  const long long row = o / KO;
  const int k = (int)(o - row * KO) * 8;
  float v[8];
  nxfp::decode_octet<BITS, EX>(
      nxfp::load_octet<BITS>(xp + o * BITS),
      nxfp::read_meta(xm, (size_t)row * KB + (k >> lbs), f),
      k & ((1 << lbs) - 1), lut, f, v);
  *reinterpret_cast<uint4*>(xd + o * 8) = make_uint4(
      bf2_bits(__floats2bfloat162_rn(v[0], v[1])),
      bf2_bits(__floats2bfloat162_rn(v[2], v[3])),
      bf2_bits(__floats2bfloat162_rn(v[4], v[5])),
      bf2_bits(__floats2bfloat162_rn(v[6], v[7])));
}

template <int BITS>
int decode_x_generic(const void* xp, const void* xm, void* xd, int M, int KB,
                     const nxfp::FmtDesc& f, cudaStream_t st) {
  const int lbs = nxfp::log2_bs(f.block_size);
  const int KO = (int)((long long)KB * f.block_size / 8);
  const long long n_oct = (long long)M * KO;
  const long long grid = (n_oct + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto xpb = reinterpret_cast<const uint8_t*>(xp);
  auto xdb = reinterpret_cast<__nv_bfloat16*>(xd);
  if (f.asym || f.ox)
    nxfp_qq_decode_x_generic_kernel<BITS, true>
        <<<(unsigned)grid, kThreads, 0, st>>>(xpb, xm, xdb, n_oct, KO, KB, lbs,
                                              f);
  else
    nxfp_qq_decode_x_generic_kernel<BITS, false>
        <<<(unsigned)grid, kThreads, 0, st>>>(xpb, xm, xdb, n_oct, KO, KB, lbs,
                                              f);
  return (int)cudaGetLastError();
}

template <int BITS, int QB, bool EX>
int launch_decode_x(const void* xp, const void* xm, void* xd,
                    long long n_blocks, const nxfp::FmtDesc& f,
                    cudaStream_t st) {
  const long long grid = (n_blocks + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  nxfp_qq_decode_x_kernel<BITS, QB, EX><<<(unsigned)grid, kThreads, 0, st>>>(
      reinterpret_cast<const uint8_t*>(xp), xm,
      reinterpret_cast<__nv_bfloat16*>(xd), n_blocks, f);
  return (int)cudaGetLastError();
}

template <int BITS, int QB>
int decode_x(const void* xp, const void* xm, void* xd, long long n_blocks,
             const nxfp::FmtDesc& f, cudaStream_t st) {
  // a symmetric format's instance carries no activation-format decode
  return (f.asym || f.ox)
             ? launch_decode_x<BITS, QB, true>(xp, xm, xd, n_blocks, f, st)
             : launch_decode_x<BITS, QB, false>(xp, xm, xd, n_blocks, f, st);
}

}  // namespace

// xd: M * KB * block_size bf16 of scratch (16-byte aligned) for the
// decoded X. splits, chunk, ws and counters: nxfp_matmul_launch's plan.
extern "C" int nxfp_qq_matmul_launch(const void* xp, const void* xm,
                                     const void* wp, const void* wm, void* y,
                                     int M, int N, int KB, const void* x_desc,
                                     const void* w_desc, void* xd, int splits,
                                     int chunk, void* ws, void* counters,
                                     void* stream) {
  const auto xf = *reinterpret_cast<const nxfp::FmtDesc*>(x_desc);
  const auto wf = *reinterpret_cast<const nxfp::FmtDesc*>(w_desc);
  auto st = reinterpret_cast<cudaStream_t>(stream);
  if (xf.block_size != wf.block_size) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const long long n_blocks = (long long)M * KB;
  int rc = (int)cudaErrorInvalidValue;
#define NXFP_QX(B, S) \
  if (xf.bits == B && xf.block_size == S) \
    rc = decode_x<B, S>(xp, xm, xd, n_blocks, xf, st);
  NXFP_QX(4, 32) NXFP_QX(5, 32) NXFP_QX(6, 32) NXFP_QX(8, 32)
  NXFP_QX(4, 16) NXFP_QX(5, 16) NXFP_QX(6, 16) NXFP_QX(8, 16)
#undef NXFP_QX
  if (!nxfp::native_fmt(xf.bits, xf.block_size)) {
    if (!nxfp::generic_fmt(xf.bits, xf.block_size))
      return (int)cudaErrorInvalidValue;
#define NXFP_QX_GEN(B) \
  if (xf.bits == B) rc = decode_x_generic<B>(xp, xm, xd, M, KB, xf, st);
    NXFP_QX_GEN(2) NXFP_QX_GEN(3) NXFP_QX_GEN(4) NXFP_QX_GEN(5)
    NXFP_QX_GEN(6) NXFP_QX_GEN(7) NXFP_QX_GEN(8)
#undef NXFP_QX_GEN
  }
  if (rc != 0) return rc;
  return nxfp_matmul_launch(xd, wp, wm, y, M, N, KB, w_desc, splits, chunk,
                            ws, counters, stream);
}
