// The quantizer's block-size-8 instances of the 4/5/6/8-bit widths
// (nxfp_quantize_kernels.cuh), in a file of their own so that nvcc
// compiles them in parallel with the main path's.
#include "nxfp_quantize_kernels.cuh"

namespace nxfpq {
NXFPQ_INSTANCES_BS8(NXFPQ_DECLARE)
}  // namespace nxfpq
