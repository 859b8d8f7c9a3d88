// Fused dequant GEMM: y (M, N) f32 = bf16(x) (M, K) @ dequant(Wq)^T.
//
// Replaces: src/repro/kernels/nxfp_matmul.py:nxfp_matmul_pallas (bodies
// _kernel and _decode_tile).
//
// Wq is stored packed (N, KB, bpb) uint8 + (N, KB) uint16 meta (uint32
// for an asym format): for each output column n the K axis is contiguous,
// KB blocks of 32 codes. Each block's tile of W is decoded once into
// shared memory as bf16 by nxfp_decode.cuh (decoded f32 value times its
// sign's block scale, or the ox outlier value, all exact, then
// round-to-nearest-even to bf16, exactly as _decode_tile), and reused by
// every row of the block's M tile. The product runs on the tensor cores
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

#include "nxfp_gemm.cuh"

namespace {

using nxfp::kBK;
using nxfp::kBN;
using nxfp::kGemmThreads;

template <int BM, int BITS, int QB, bool EX>
__global__ void __launch_bounds__(kGemmThreads)
nxfp_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ packed,
                   const void* __restrict__ meta, float* __restrict__ y,
                   int M, int N, int KB, nxfp::FmtDesc fd) {
  __shared__ __align__(16) nxfp::TileRow xs[BM];
  __shared__ __align__(16) nxfp::TileRow ws[kBN];
  __shared__ float lut[2 << BITS];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int K = KB * QB;
  nxfp::fill_lut<BITS>(lut, fd, tid, kGemmThreads);
  float acc[BM / 16][2][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // previous tile consumed (and the LUT written)
    // x tile: BM x kBK bf16, 8 values (16 bytes) per load; K is a multiple
    // of 16, so a chunk is either wholly inside K or wholly past it
    for (int c = tid; c < BM * kBK / 8; c += kGemmThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + kc < K)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(&xs[r][kc]) = v;
    }
    nxfp::decode_tile<kBN, BITS, QB, EX>(ws, packed, meta, n0, N, k0 / QB, KB,
                                         lut, fd, tid);
    __syncthreads();
    nxfp::mma_tile<BM>(xs, ws, acc, tid);
  }
  nxfp::store_tile<BM>(y, acc, m0, n0, M, N, tid);
}

template <int BM, int BITS, int QB>
void launch(const void* x, const void* packed, const void* meta, void* y,
            int M, int N, int KB, const nxfp::FmtDesc& fd, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  // the weights and the KV cache are symmetric: their kernel carries no
  // activation-format decode
  auto kernel = (fd.asym || fd.ox) ? nxfp_matmul_kernel<BM, BITS, QB, true>
                                   : nxfp_matmul_kernel<BM, BITS, QB, false>;
  kernel<<<grid, kGemmThreads, 0, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const uint8_t*>(packed), meta,
      reinterpret_cast<float*>(y), M, N, KB, fd);
}

template <int BITS, int QB>
void launch_m(const void* x, const void* packed, const void* meta, void* y,
              int M, int N, int KB, const nxfp::FmtDesc& fd, cudaStream_t st) {
  if (M <= 16) launch<16, BITS, QB>(x, packed, meta, y, M, N, KB, fd, st);
  else launch<64, BITS, QB>(x, packed, meta, y, M, N, KB, fd, st);
}

}  // namespace

extern "C" int nxfp_matmul_launch(const void* x, const void* packed,
                                  const void* meta, void* y, int M, int N,
                                  int KB, const void* fmt_desc, void* stream) {
  const nxfp::FmtDesc fd = *reinterpret_cast<const nxfp::FmtDesc*>(fmt_desc);
  const int bits = fd.bits, block_size = fd.block_size;
  if (M == 0 || N == 0) return 0;
  auto st = reinterpret_cast<cudaStream_t>(stream);
#define NXFP_MM(B, S) \
  if (bits == B && block_size == S) launch_m<B, S>(x, packed, meta, y, M, N, KB, fd, st); else
  NXFP_MM(4, 32) NXFP_MM(5, 32) NXFP_MM(6, 32) NXFP_MM(8, 32)
  NXFP_MM(4, 16) NXFP_MM(5, 16) NXFP_MM(6, 16) NXFP_MM(8, 16)
  return (int)cudaErrorInvalidValue;
#undef NXFP_MM
  return (int)cudaGetLastError();
}
