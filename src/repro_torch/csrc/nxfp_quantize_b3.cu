// The quantizer's 3-bit instances, every block size
// (nxfp_quantize_kernels.cuh), in a file of their own so that nvcc
// compiles them in parallel with the main path's.
#include "nxfp_quantize_kernels.cuh"

namespace nxfpq {
NXFPQ_INSTANCES_3(NXFPQ_DECLARE)
}  // namespace nxfpq
