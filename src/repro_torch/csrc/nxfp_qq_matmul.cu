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
// As the TPU kernel, every packed block of BOTH operands is decoded to f32
// (element value x its sign's block scale, or the ox outlier value; all
// exact) and rounded to bf16 with round-to-nearest-even (nxfp_decode.cuh:
// decode_block_bf16), and the bf16 tiles are multiplied with f32
// accumulation on the tensor cores (nxfp_gemm.cuh: mma.sync m16n8k16
// bf16 -> f32). M rows past the end read as zeros, as the reference's
// zero-padded rows (meta 0) decode to exact zeros. Any block count along
// K: a code is read at bit offset i*bits, so 5/6-bit widths need no
// two-block tile.
//
// Bound on the H100: at prefill (M = 512) the bf16 tensor-core FLOPs,
// 2*M*N*K; the packed bytes of both operands are ~(bits_x + bits_w)/32 of
// the bf16 product's. Design: the dequant GEMM of nxfp_matmul.cu with one
// change -- the X tile is decoded from packed blocks into shared memory
// instead of loaded as bf16. A 16-row M tile when M <= 16, else 64 rows; a
// 64-column N tile; K steps of 128. Each X block is decoded once per N
// tile and each W block once per M tile (M/64 and N/64 times in all), and
// there is no copy/compute overlap (no cp.async/TMA pipeline, no wgmma):
// that is the first thing to make faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nxfp_gemm.cuh"

namespace {

using nxfp::kBK;
using nxfp::kBN;
using nxfp::kGemmThreads;

template <int BM, int BX, int BW, int QB>
__global__ void __launch_bounds__(kGemmThreads)
nxfp_qq_matmul_kernel(const uint8_t* __restrict__ xp,
                      const void* __restrict__ xm,
                      const uint8_t* __restrict__ wp,
                      const void* __restrict__ wm, float* __restrict__ y,
                      int M, int N, int KB, nxfp::FmtDesc xf,
                      nxfp::FmtDesc wf) {
  __shared__ __align__(16) nxfp::TileRow xs[BM];
  __shared__ __align__(16) nxfp::TileRow ws[kBN];
  __shared__ float lut_x[2 << BX];
  __shared__ float lut_w[2 << BW];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  nxfp::fill_lut<BX>(lut_x, xf, tid, kGemmThreads);
  nxfp::fill_lut<BW>(lut_w, wf, tid, kGemmThreads);
  float acc[BM / 16][2][4] = {};

  for (int kb0 = 0; kb0 < KB; kb0 += kBK / QB) {
    __syncthreads();  // previous tiles consumed (and the LUTs written)
    nxfp::decode_tile<BM, BX, QB, true>(xs, xp, xm, m0, M, kb0, KB, lut_x, xf,
                                        tid);
    nxfp::decode_tile<kBN, BW, QB, true>(ws, wp, wm, n0, N, kb0, KB, lut_w, wf,
                                         tid);
    __syncthreads();
    nxfp::mma_tile<BM>(xs, ws, acc, tid);
  }
  nxfp::store_tile<BM>(y, acc, m0, n0, M, N, tid);
}

struct Args {
  const void *xp, *xm, *wp, *wm;
  void* y;
  int M, N, KB;
  nxfp::FmtDesc xf, wf;
  cudaStream_t st;
};

template <int BM, int BX, int BW, int QB>
int launch(const Args& a) {
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM);
  nxfp_qq_matmul_kernel<BM, BX, BW, QB><<<grid, kGemmThreads, 0, a.st>>>(
      reinterpret_cast<const uint8_t*>(a.xp), a.xm,
      reinterpret_cast<const uint8_t*>(a.wp), a.wm,
      reinterpret_cast<float*>(a.y), a.M, a.N, a.KB, a.xf, a.wf);
  return (int)cudaGetLastError();
}

template <int BX, int BW, int QB>
int launch_m(const Args& a) {
  return a.M <= 16 ? launch<16, BX, BW, QB>(a) : launch<64, BX, BW, QB>(a);
}

template <int BX, int QB>
int dispatch_w(const Args& a) {
  switch (a.wf.bits) {
    case 4: return launch_m<BX, 4, QB>(a);
    case 5: return launch_m<BX, 5, QB>(a);
    case 6: return launch_m<BX, 6, QB>(a);
    case 8: return launch_m<BX, 8, QB>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int QB>
int dispatch_x(const Args& a) {
  switch (a.xf.bits) {
    case 4: return dispatch_w<4, QB>(a);
    case 5: return dispatch_w<5, QB>(a);
    case 6: return dispatch_w<6, QB>(a);
    case 8: return dispatch_w<8, QB>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int nxfp_qq_matmul_launch(const void* xp, const void* xm,
                                     const void* wp, const void* wm, void* y,
                                     int M, int N, int KB, const void* x_desc,
                                     const void* w_desc, void* stream) {
  const Args a{xp, xm, wp, wm, y, M, N, KB,
               *reinterpret_cast<const nxfp::FmtDesc*>(x_desc),
               *reinterpret_cast<const nxfp::FmtDesc*>(w_desc),
               reinterpret_cast<cudaStream_t>(stream)};
  if (a.xf.block_size != a.wf.block_size) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  switch (a.xf.block_size) {
    case 32: return dispatch_x<32>(a);
    case 16: return dispatch_x<16>(a);
  }
  return (int)cudaErrorInvalidValue;
}
