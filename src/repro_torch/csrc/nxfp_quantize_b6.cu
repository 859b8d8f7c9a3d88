// The quantizer's 6-bit instances (nxfp_quantize_kernels.cuh), in a file
// of their own so that nvcc compiles the code widths in parallel.
#include "nxfp_quantize_kernels.cuh"

namespace nxfpq {
NXFPQ_INSTANCES_6(NXFPQ_DECLARE)
}  // namespace nxfpq
