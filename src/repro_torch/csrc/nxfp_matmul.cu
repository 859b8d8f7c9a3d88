// Fused dequant GEMM: y (M, N) f32 = bf16(x) (M, K) @ bf16(dequant(Wq))^T.
//
// Replaces: src/repro/kernels/nxfp_matmul.py:nxfp_matmul_pallas (bodies
// _kernel and _decode_tile).
//
// Wq is stored packed (N, KB, bpb) uint8 + (N, KB) meta, uint16 (uint32
// for an asym format): for each output column n the K axis is contiguous,
// KB blocks of 8 to 128 codes of 2 to 8 bits (nxfp_decode.cuh: the main
// path's 4/5/6/8 bits at bs 16/32 read whole blocks, every other format a
// row as one long block).
//
// Bound on the H100: at decode (M = batch, a few rows) the packed weight
// bytes, ~4.5 bits per weight: a Llama-3-8B step streams 3.9 GB, >= 1.17 ms
// at 3.35 TB/s. At prefill (M = 512) the bf16 tensor-core FLOPs, 2*M*N*K.
// Design for that: two kernels, one launch per call. The caller picks the
// regime (kernels/nxfp_matmul.py, from nxfp_matmul_decode_geometry): a
// split plan (splits > 0) runs the decode kernel, none the prefill kernel.
// - M <= 16: nxfp_matmul_decode.cu, weight streaming with a deterministic
//   split-K (mma.sync, partials summed in split order by the last CTA of
//   each tile).
// - M > 16: nxfp_matmul_prefill.cu, wgmma with W decoded into the
//   register A operand and x fed by a TMA/cp.async ring on mbarriers.
// How far each got: PERF.md (kernel table, PR 14).
#include <cuda_runtime.h>

#include "nxfp_matmul.cuh"

extern "C" int nxfp_matmul_launch(const void* x, const void* packed,
                                  const void* meta, void* y, int M, int N,
                                  int KB, const void* fmt_desc, int splits,
                                  int chunk, void* ws, void* counters,
                                  void* stream) {
  const nxfp::FmtDesc fd = *reinterpret_cast<const nxfp::FmtDesc*>(fmt_desc);
  if (M == 0 || N == 0) return 0;
  auto st = reinterpret_cast<cudaStream_t>(stream);
  if (splits > 0)
    return nxfp_matmul_decode(x, packed, meta, y, M, N, KB, splits, chunk, ws,
                              counters, fd, st);
  return nxfp_matmul_prefill(x, packed, meta, y, M, N, KB, fd, st);
}
